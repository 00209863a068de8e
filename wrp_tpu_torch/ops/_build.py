"""Build and load the port's CUDA kernels: `nvcc` at first use, `ctypes` after.

The sources in ``wrp_tpu_torch/csrc/`` compile into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  The library's file name carries a hash of the sources and flags:
it is rebuilt when a source changes and reused otherwise.  The build
directory ``wrp_tpu_torch/_build/`` is listed in .gitignore.

There is no fallback: if `nvcc` is missing or the build fails, loading
raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

#: sm_90a keeps Hopper-only instructions available to later kernels.  No
#: --use_fast_math: the Parseval epilogue's subtraction needs IEEE fp32.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not);
    the compiler's `-Xptxas=-v` report is beside it as ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwrp_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (shutil.which("nvcc"),
                 str(Path(home) / "bin" / "nvcc") if home else None,
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use and need the CUDA toolkit (set CUDA_HOME)")


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.wrp_fused_chain_radix.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, ptr,   # x, x_is_int16, a, fac, wd, ph, out
                i32, i32, i32, i32, i32,             # bc, m, n, radix, tile
                ptr]                                 # stream
            lib.wrp_fused_chain_radix.restype = i32
            lib.wrp_cuda_error_string.argtypes = [i32]
            lib.wrp_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
