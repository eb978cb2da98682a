"""ray_tpu_torch.experimental — utility surface (ref analog:
python/ray/experimental/: internal_kv.py, tqdm_ray.py)."""

from ray_tpu_torch.experimental import internal_kv, tqdm_rayt  # noqa: F401
from ray_tpu_torch.experimental.tqdm_rayt import tqdm  # noqa: F401
