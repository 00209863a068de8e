"""Build and load the port's native host library (the wire codec and the
UDP ingest loop): g++ at first use, `ctypes` after.

``codec.cpp`` and ``ingest.cpp`` in this directory compile into one shared
library in ``wrp_tpu_torch/_build/`` (listed in .gitignore), never into the
package directory.  Its file name carries a hash of the sources, the flags
and the host (``-march=native`` code runs only where it was built), so it
is rebuilt when any of them changes and reused otherwise.  There is no
fallback: if g++ is missing or the build fails, loading raises with the
compiler's output.  Nothing here runs at import time.

    python -m wrp_tpu_torch.native.build     # build now, print the path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "codec.cpp", HERE / "ingest.cpp")
BUILD_DIR = HERE.parent / "_build"
#: wrp_tpu/native/build.py's flags
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwrp_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there yet."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native codec and UDP ingest "
                           "are compiled at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([cxx, *CXX_FLAGS, *map(str, SOURCES), "-o",
                               str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {done.returncode}) building "
                               f"{so.name}:\n{done.stdout}")
        os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load_library() -> ctypes.CDLL:
    """The native library with its functions' signatures, built first if
    the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            signatures = {
                # wire, out, m, n, ch, num_threads
                "wrp_decode_iq": ([ptr, ptr, i64, i64, i64, i32], None),
                "wrp_decode_iq_i16": ([ptr, ptr, i64, i64, i64, i32], None),
                # ... group, slot
                "wrp_decode_iq_i16_grouped": (
                    [ptr, ptr, i64, i64, i64, i32, i32, i64], None),
                # planar, wire, m, n, ch
                "wrp_encode_iq": ([ptr, ptr, i64, i64, i64], None),
                # src, dst, count
                "wrp_encode_be_f32": ([ptr, ptr, i64], None),
                # fd, timeout_ms, out, rows, row_bytes, stats, hdr
                "wrp_udp_recv_sector": (
                    [i32, i32, ptr, i64, i64, ptr, ptr], i32),
                # fd, slot_bytes, nslots -> drain
                "wrp_udp_drain_start": ([i32, i64, i64], ptr),
                # drain, timeout_ms, out, rows, row_bytes, stats, hdr
                "wrp_udp_drain_recv_sector": (
                    [ptr, i32, ptr, i64, i64, ptr, ptr], i32),
                "wrp_udp_drain_stop": ([ptr], None),
                "wrp_udp_drain_free": ([ptr], None),
            }
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


if __name__ == "__main__":
    print(build())
