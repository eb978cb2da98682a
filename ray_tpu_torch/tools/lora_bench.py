"""The LoRA fine-tune throughput leg (the port's twin of the JAX package's
``tools/lora_bench.py``): ``bench``'s train step with rank-16 adapters on
wq wk wv wo over a frozen base (adapter-only gradients and optimizer
state), MFU on 2/3 of the FLOPs, as one JSON line with the time it was
taken (``captured_at``).

Run it as ``python -m ray_tpu_torch.tools.lora_bench``. It measures where
it runs, the card unless ``--device cpu`` is given; it keeps no cache and
writes a file only where ``--out`` names one.
"""

from __future__ import annotations

import time

from ray_tpu_torch.tools import _common, bench


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.lora_bench",
                        __doc__.split("\n")[0])
    ap.add_argument("--preset", default="410m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rank", type=int, default=16)
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    result = bench.run(device, args.preset, args.batch, args.seq,
                       args.steps, lora_rank=args.rank)
    result["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())
    return _common.finish(result, args)


if __name__ == "__main__":
    main()
