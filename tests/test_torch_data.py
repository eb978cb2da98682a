"""The port's data plane against the JAX package on the same raw input.

``build_corpus`` (content-hash dedup through a hash exchange, a byte
tokenizer, the ``random_shuffle`` exchange, packed ``.npz`` shards) runs in
the JAX package on a cluster of its own in a subprocess and in the port on
a port cluster here, from the same seeded jsonl files and seed: the shards
are equal member for member, byte for byte (the ``.npy`` payload of each
zip member; the zip's timestamps differ). ``TokenCorpus(shard_tasks=True)``
streams those shards through each package's streaming executor: the port's
stream equals the reference's and its own inline (``shard_tasks=False``)
stream bit for bit. Running the port's exchange leaves none of the port's
own modules registered for by-value code shipping.
"""

import json
import os
import subprocess
import sys
import textwrap
import zipfile

import cloudpickle
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_FILES, DOCS_PER_FILE, DUP_SHARE = 16, 12, 0.25
NUM_SHARDS, SEED, SEQ_LEN = 4, 11, 64


def byte_tokenize(text: str) -> list:
    """UTF-8 bytes shifted past 0 (the EOS id)."""
    return [b + 1 for b in text.encode("utf-8")]


def write_raw_corpus(root: str, seed: int = 3) -> str:
    """NUM_FILES jsonl files of seeded documents, DUP_SHARE of them copies
    of earlier ones (in other files too), so dedup has work."""
    rng = np.random.default_rng(seed)
    words = ["tensor", "card", "shard", "token", "block", "stream", "page",
             "kernel", "queue", "lease"]
    docs = []
    for i in range(NUM_FILES * DOCS_PER_FILE):
        if docs and rng.random() < DUP_SHARE:
            docs.append(docs[int(rng.integers(0, len(docs)))])
        else:
            n = int(rng.integers(4, 40))
            docs.append(f"doc {i}: " + " ".join(
                words[j] for j in rng.integers(0, len(words), n)))
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    for f in range(NUM_FILES):
        with open(os.path.join(raw, f"part-{f:03d}.jsonl"), "w") as out:
            for text in docs[f * DOCS_PER_FILE:(f + 1) * DOCS_PER_FILE]:
                out.write(json.dumps({"text": text}) + "\n")
    return raw


_REFERENCE = textwrap.dedent('''
    import sys

    import numpy as np

    import ray_tpu as rt
    from ray_tpu.data.llm_corpus import TokenCorpus, build_corpus


    def byte_tokenize(text):
        return [b + 1 for b in text.encode("utf-8")]


    raw, out, stream_path = sys.argv[1:4]
    num_shards, seed, seq_len = map(int, sys.argv[4:7])
    rt.init(num_cpus=2)
    try:
        build_corpus(raw, out, tokenize=byte_tokenize,
                     num_shards=num_shards, seed=seed)
        blocks = list(TokenCorpus(out, seq_len=seq_len, eos_id=0,
                                  shard_tasks=True))
        np.savez(stream_path,
                 tokens=np.stack([b["tokens"] for b in blocks]),
                 segment_ids=np.stack([b["segment_ids"] for b in blocks]))
    finally:
        rt.shutdown()
''')


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The raw corpus, the reference's shards and shard-task stream (a
    subprocess with its own ray_tpu cluster), and the port's shards and
    streams (a port cluster here)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data.llm_corpus import TokenCorpus, build_corpus

    root = str(tmp_path_factory.mktemp("corpus"))
    raw = write_raw_corpus(root)
    ref_out = os.path.join(root, "ref")
    ref_stream = os.path.join(root, "ref_stream.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, raw, ref_out, ref_stream,
         str(NUM_SHARDS), str(SEED), str(SEQ_LEN)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    port_out = os.path.join(root, "port")
    rt.init(num_cpus=4)
    try:
        before = set(cloudpickle.cloudpickle._PICKLE_BY_VALUE_MODULES)
        paths = build_corpus(raw, port_out, tokenize=byte_tokenize,
                             num_shards=NUM_SHARDS, seed=SEED)
        registered = (set(cloudpickle.cloudpickle._PICKLE_BY_VALUE_MODULES)
                      - before)
        kw = dict(seq_len=SEQ_LEN, eos_id=0)
        tasks = list(TokenCorpus(port_out, shard_tasks=True, **kw))
    finally:
        rt.shutdown()
    inline = list(TokenCorpus(port_out, **kw))
    with np.load(ref_stream) as z:
        ref = {k: z[k] for k in z.files}
    return {"raw": raw, "ref_out": ref_out, "port_out": port_out,
            "paths": paths, "registered": registered, "tasks": tasks,
            "inline": inline, "ref_stream": ref}


def _members(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_build_corpus_shards_equal_the_reference_byte_for_byte(built):
    names = sorted(os.listdir(built["port_out"]))
    assert names == sorted(os.listdir(built["ref_out"]))
    assert names == [f"shard-{i:05d}.npz" for i in range(NUM_SHARDS)]
    assert built["paths"] == [os.path.join(built["port_out"], n)
                              for n in names]
    for name in names:
        port = _members(os.path.join(built["port_out"], name))
        ref = _members(os.path.join(built["ref_out"], name))
        assert sorted(port) == ["doc_lens.npy", "tokens.npy"]
        assert port == ref, name


def test_build_corpus_dedups_and_shuffles(built):
    """Every distinct raw document survives once, tokenized; the shuffle
    reorders them."""
    from ray_tpu_torch.data.llm_corpus import load_shard_docs

    texts = []
    for name in sorted(os.listdir(built["raw"])):
        with open(os.path.join(built["raw"], name)) as f:
            texts.extend(json.loads(line)["text"] for line in f)
    distinct = list(dict.fromkeys(texts))
    assert len(texts) - len(distinct) >= 0.1 * len(texts)
    written = [tuple(d.tolist()) for p in built["paths"]
               for d in load_shard_docs(p)]
    want = [tuple(byte_tokenize(t)) for t in distinct]
    assert sorted(written) == sorted(want)
    assert written != want


def test_shard_task_stream_equals_the_reference_and_the_inline_stream(built):
    tasks, inline, ref = built["tasks"], built["inline"], built["ref_stream"]
    assert len(tasks) == len(inline) == len(ref["tokens"]) > 10
    for got, want in zip(tasks, inline):
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["segment_ids"], want["segment_ids"])
    assert np.array_equal(np.stack([b["tokens"] for b in tasks]),
                          ref["tokens"])
    assert np.array_equal(np.stack([b["segment_ids"] for b in tasks]),
                          ref["segment_ids"])


def test_exchange_ships_the_ports_modules_by_reference(built):
    """The exchange registers its user callables' modules for by-value
    shipping (the tokenizer's test module), never a module of the port:
    cloudpickle's registry is process-wide, and a by-value copy of the
    port's classes would fail later workers' isinstance checks."""
    assert built["registered"] <= {__name__}
    assert not [m for m in cloudpickle.cloudpickle._PICKLE_BY_VALUE_MODULES
                if m.split(".")[0] in ("ray_tpu", "ray_tpu_torch")]


def _straggling_split(block, n, idx):
    """split_partition, with map 0 finishing last."""
    import time as _time

    from ray_tpu_torch.data.block import split_partition

    if idx == 0:
        _time.sleep(1.5)
    return split_partition(block, n, idx)


def test_folds_run_past_a_straggling_first_map():
    """A straggling map 0 holds back no fold: runs of consecutive map
    indices fold while it runs, each in its place, and every partition
    concatenates its rows in map-index order, as an in-order exchange
    does. (The JAX package delivers shards in map-index order, so there
    map 0 finishing last leaves 0 folds: its test_exchange's
    test_reduce_starts_before_all_maps_finish failed 4 of 5 alone.)"""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data.block import NumpyBlock, split_partition
    from ray_tpu_torch.data.exchange import (ExchangeController,
                                             ExchangeSpec, _runs)
    from ray_tpu_torch.data.streaming_executor import ExecutionOptions

    assert _runs({1: 0, 2: 0, 4: 0, 5: 0, 6: 0, 9: 0}, 2) == [[1, 2],
                                                            [4, 5, 6]]
    assert _runs({3: 0, 7: 0}, 2) == []
    blocks = [NumpyBlock({"x": np.arange(100) + 100 * i}) for i in range(10)]
    want = [np.concatenate([split_partition(b, 4, i)[j].cols["x"]
                            for i, b in enumerate(blocks)])
            for j in range(4)]
    rt.init(num_cpus=4)
    try:
        ctl = ExchangeController(
            ExchangeSpec(4, map_fn=_straggling_split, fold_min=2),
            options=ExecutionOptions(max_in_flight=3))
        out = ctl.run([rt.put(b) for b in blocks])
        got = [rt.get(r).cols["x"] for r in out]
    finally:
        rt.shutdown()
    stats = ctl.stats
    assert stats.map_tasks == stats.maps_done == 10
    assert stats.folds > 0 and 0 < stats.maps_done_at_first_fold < 10, stats
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
