"""The port's kernel build (ray_tpu_torch.ops.cuda._build): every CUDA source
and header is compiled or hashed, so a changed file always rebuilds the
library. Runs on the CPU: nothing here calls nvcc."""

import shutil

from ray_tpu_torch.ops.cuda import _build


def test_every_csrc_file_is_named_in_the_build():
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.is_file()}
    named = set(_build.SOURCES) | set(_build.HEADERS)
    assert on_disk == named, (
        f"not in _build.SOURCES/HEADERS: {sorted(on_disk - named)}; "
        f"named but missing: {sorted(named - on_disk)}")
    assert all(name.endswith(".cu") for name in _build.SOURCES)
    assert all(name.endswith(".cuh") for name in _build.HEADERS)


def test_digest_follows_every_header(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build._digest()
    for name in _build.HEADERS:
        path = copy / name
        path.write_text(path.read_text() + "\n// edited\n")
        after = _build._digest()
        assert after != before, f"editing {name} keeps the library's hash"
        before = after
