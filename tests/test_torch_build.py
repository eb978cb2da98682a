"""The port's kernel build (ray_tpu_torch.ops.cuda._build): every CUDA source
and header is compiled or hashed, so a changed file always rebuilds the
library, and every C entry point gets its ctypes signature. Runs on the CPU:
nothing here calls nvcc."""

import ctypes
import re
import shutil
from pathlib import Path

from ray_tpu_torch.ops.cuda import _build

# extern "C" <return type> <name>(<parameters>) {
_ENTRY = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')


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


def _entry_points() -> dict:
    """name -> (return type, [parameter types]) of every extern "C"
    function defined in the csrc sources, read from their text."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _ENTRY.findall(path.read_text()):
            types = [re.sub(r"\s*\b\w+$", "", p.strip())
                     for p in params.split(",") if p.strip()]
            found[name] = (" ".join(ret.split()), types)
    return found


class _Fn:
    """Stands in for one ctypes function: keeps what library() sets."""


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _Fn())


def _ctype_matches(c_type: str, py_type) -> bool:
    if "*" in c_type:
        return py_type is ctypes.c_void_p or py_type is ctypes.c_char_p or (
            isinstance(py_type, type) and issubclass(py_type, ctypes._Pointer))
    return {"int": ctypes.c_int, "float": ctypes.c_float}.get(c_type) is py_type


def test_every_entry_point_gets_argtypes_and_restype(monkeypatch):
    """An entry point that library() leaves unsigned would take ctypes'
    default int conversions: a pointer cut to 32 bits, a float passed as an
    int. Every extern "C" function in csrc/*.cu gets both, matching its
    C declaration parameter by parameter."""
    entries = _entry_points()
    assert {"rtt_flash_fwd", "rtt_flash_bwd_dq", "rtt_flash_bwd_dkv",
            "rtt_flash_bwd_dq_sm90_smem"} <= set(entries)
    fake = _FakeLib()
    monkeypatch.setattr(_build, "build", lambda: (Path("unbuilt.so"), 0.0))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake)
    _build.library.__wrapped__()
    for name, (ret, params) in entries.items():
        fn = fake.fns.get(name)
        assert fn is not None and hasattr(fn, "argtypes") and hasattr(
            fn, "restype"), f"_build.library() does not sign {name}"
        assert len(fn.argtypes) == len(params), (
            f"{name}: {len(params)} C parameters, {len(fn.argtypes)} argtypes")
        for i, (c_type, py_type) in enumerate(zip(params, fn.argtypes)):
            assert _ctype_matches(c_type, py_type), (
                f"{name}: parameter {i} is {c_type!r}, argtype {py_type}")
        assert _ctype_matches(ret, fn.restype), (
            f"{name}: returns {ret!r}, restype {fn.restype}")
