"""Build and load the port's CUDA kernels: `nvcc` at first use, `ctypes` after.

The sources in ``wrp_tpu_torch/csrc/`` compile into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes): one `nvcc -c` per ``.cu`` file, all started together, then one
link, so a build takes as long as its slowest source rather than their sum
(each source's time is in the build log; `chip_smoke.py` prints them).
The library's file name carries a hash of the sources and flags: it is
rebuilt when a source changes and reused otherwise.  The build directory
``wrp_tpu_torch/_build/`` is listed in .gitignore.

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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

#: sm_90a keeps Hopper-only instructions available to later kernels.  No
#: --use_fast_math: the Parseval epilogue's subtraction needs IEEE fp32.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

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


def _run(cmds: dict) -> str:
    """Run every command of {label: argv} at once and wait for all; raise
    on a failure with its command and output, else return a log of each
    one's output and wall seconds (lines "== label: 1.23 s")."""
    def one(cmd):
        t0 = time.perf_counter()
        done = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return done, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        results = dict(zip(cmds, pool.map(one, cmds.values())))
    log = []
    for label, (done, secs) in results.items():
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {done.returncode}): "
                               f"{' '.join(cmds[label])}\n{done.stdout}")
        log.append(f"== {label}: {secs:.2f} s\n{done.stdout}")
    return "".join(log)


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o"
            for src in sorted(CSRC.glob("*.cu"))}
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        log = _run({src.name: [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)] for src, obj in objs.items()})
        log += _run({"link": [nvcc, "-shared", "-gencode",
                              "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                              *(str(o) for o in objs.values())]})
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs.values():
            obj.unlink(missing_ok=True)


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
            i64, f32 = ctypes.c_longlong, ctypes.c_float
            planar = [ptr, i32, ptr, ptr, ptr, ptr, ptr,  # x, x_is_int16, tab, phi, wd, ph, out
                      i32, i32, i32, i32, i32, i64]      # bc, m, n, cols, blocks, offset
            wire = [ptr, ptr, ptr, ptr, ptr, ptr,         # w, tab, phi, wd, ph, out
                    i32, i32, i32, i32, i32, i32, i64]    # bs, m, n, ch, cols, blocks, offset
            # resident blocks per SM and clusters (the last two, int*)
            occupancy = [i32, i32, i32, ptr, ptr]         # m, cols, blocks
            signatures = {
                "wrp_fused_chain_radix": planar + [ptr],              # stream
                "wrp_fused_chain_radix_salted": planar + [i32, ptr],  # salt, stream
                "wrp_fused_chain_wire": wire + [ptr],
                "wrp_fused_chain_wire_salted": wire + [i32, ptr],
                "wrp_fused_chain_radix_occupancy": occupancy,
                "wrp_fused_chain_wire_occupancy": occupancy,
                "wrp_fused_chain_dense": [
                    ptr, i32, ptr, ptr, ptr, ptr,     # x, x_is_int16, a, wd, ph, out
                    i32, i32, i32, i32, i64,          # bc, m, n, tile, offset
                    ptr],                             # stream
                "wrp_fused_chain_astage": [
                    ptr, i32, ptr, ptr,               # x, x_is_int16, tab, y
                    i32, i32, i32, i32, i32,          # bc, m, w, cols, blocks
                    ptr],                             # stream
                "wrp_fused_chain_astage_occupancy": [
                    i32, i32, ptr],                   # m, cols, int* blocks per SM
                "wrp_parseval_rows": [
                    ptr, ptr, ptr, ptr,               # y, wd, ph, out
                    i32, i32, i32,                    # bc, rows, n
                    ptr],                             # stream
                "wrp_fused_stage2": [
                    ptr, ptr, ptr, ptr,               # yr, yi, br, bi
                    ptr, i64, ptr,                    # scratch, its floats, out
                    i64, i32, f32,                    # total_rows, n, tap_sum
                    ptr],                             # stream
                "wrp_radix_chain_ablation": [
                    ptr, ptr, ptr, ptr, ptr, ptr,     # x, a, fac, wd, ph, out
                    i32, i32, i32, i32, i32, i64,     # bc, m, n, radix, tile, offset
                    i32, i32, ptr],                   # salt, mode, stream
                "wrp_radix_chain_astage": [
                    ptr, ptr, ptr, ptr,               # x (int16), a, fac, y
                    i32, i32, i32, i32, i32,          # bc, m, w, radix, tile
                    i64, ptr],                        # min_smem, stream
                # resident blocks per SM (the last argument, int*)
                "wrp_radix_chain_ablation_blocks_per_sm": [
                    i32, i32, i32, i32, i32, i64,     # mode, radix, tile, m, n, min_smem
                    ptr],
                "wrp_tc_dot_probe": [
                    ptr, ptr, ptr,                    # a, x, out
                    i32, i32, i32, i32,               # M, K, width, wmax
                    i32, i32, i32, i32, ptr],         # distinct, ndots, steps, blocks, stream
                "wrp_int_split_dot": [
                    ptr, ptr, ptr,                    # x, a, out
                    i32, i32, i32, ptr],              # m, n, variant, stream
                # the launch's blocks (-1: shapes the entry refuses)
                "wrp_int_split_dot_blocks": [i32, i32],               # m, n
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i32
            # the persistent grid's units of a call (-1: refused shapes);
            # M, K, width, ndots, steps
            lib.wrp_tc_dot_probe_units.argtypes = [i32, i32, i32, i32, i32]
            lib.wrp_tc_dot_probe_units.restype = i64
            lib.wrp_cuda_error_string.argtypes = [i32]
            lib.wrp_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
