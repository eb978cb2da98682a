"""Build and load the port's CUDA kernels.

The sources under ``ray_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at the first CUDA launch (never at import, so the
package imports where there is no ``nvcc``) and again whenever a source or a
flag changes: the library's name carries a hash of both. Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, then linked.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "flash_attention_fwd_sm90.cu", "flash_attention_bwd_dq_sm90.cu",
           "flash_attention_bwd_sm90.cu")
HEADERS = ("flash_common.cuh", "flash_sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compiles the kernels unless a library for these sources exists.
    Returns (path, seconds spent building; 0.0 when it already existed).
    The compiler's resource report (-Xptxas=-v) goes to ``<lib>.log``."""
    out = BUILD_DIR / f"libray_tpu_torch_{_digest()}.so"
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(str(out) + ".log").write_text("\n".join(logs))
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing
    return out, time.perf_counter() - t0


_PTR = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int)
_INT = ctypes.c_int
_F32 = ctypes.c_float


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.rtt_flash_fwd.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                  _I64P, _I32P, _F32, _PTR]
    lib.rtt_flash_bwd_dq.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                     _PTR, _PTR, _I64P, _I32P, _F32, _PTR]
    lib.rtt_flash_bwd_dkv.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                      _PTR, _PTR, _PTR, _I64P, _I32P, _F32,
                                      _PTR]
    for fn in (lib.rtt_flash_fwd, lib.rtt_flash_bwd_dq, lib.rtt_flash_bwd_dkv):
        fn.restype = ctypes.c_int
    for fn in (lib.rtt_flash_fwd_sm90_smem, lib.rtt_flash_bwd_dq_sm90_smem,
               lib.rtt_flash_bwd_dkv_sm90_smem):
        fn.argtypes = [_INT]
        fn.restype = ctypes.c_int
    lib.rtt_error_string.argtypes = [_INT]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raises if a C entry returned a CUDA error."""
    if code != 0:
        msg = lib.rtt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
