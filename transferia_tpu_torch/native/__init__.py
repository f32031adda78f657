"""The port's C++ host library, built with the host compiler and bound
with ctypes.

``csrc/hostops.cpp``, ``csrc/parquetdec.cpp`` and the
``csrc/parquetdec_ba.inc`` it includes are verbatim copies of the JAX
package's host library (their header comments describe that package's
build).  They are host code: they run on the CPU, put nothing on the
card and port no device program.  Callers: the Kafka wire (CRC32C,
record encode and scan), the ClickHouse RowBinary encoder (varints,
byte scatter), the host mask (HMAC-SHA256), `ColumnBatch.filter`/`take`
(the gathers), the fused step's host SHA-block pack and the Parquet
reader (`pq_*`).

The library builds at first use with ``g++`` (or ``clang++``) into
``build/torch_kernels/`` at the root of the checkout, apart from the
CUDA kernels (`ops/_build.py` needs ``nvcc``; this needs only a host
compiler, so the CPU tests run it).  The file name carries a digest of
every source, included part and flag, so an edited source rebuilds.  A
build writes a temporary name and renames it into place, so concurrent
first uses (test workers, upload threads) never load a partial file.
There is no fallback: without a compiler, or when the build fails, `lib`
raises RuntimeError, and a symbol missing from the build raises
AttributeError while it binds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import numpy.ctypeslib as npc

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"

# the JAX package's flags: no -march=native, the SHA-NI and SSE4.2 paths
# are picked at run time by cpuid
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LINK_FLAGS = ("-ldl",)

HOSTOPS_SOURCES = (CSRC / "hostops.cpp", CSRC / "parquetdec.cpp")
HOSTOPS_DEPS = (CSRC / "parquetdec_ba.inc",)  # parquetdec.cpp includes it

_lock = threading.Lock()
_lib: Optional["_ProfiledLib"] = None


def _compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or clang++) on PATH: the "
                           "port's host library cannot be built")
    return cxx


def library_path(name: str, sources: Sequence[Path],
                 deps: Sequence[Path] = ()) -> Path:
    """Where the build of these sources lives: the name carries a digest
    of every source, included part and flag."""
    h = hashlib.sha256()
    for p in (*sources, *deps):
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host_library(name: str, sources: Sequence[Path],
                       deps: Sequence[Path] = ()) -> Path:
    """Compile sources into a shared library unless the digest-named
    file exists; returns its path.  Raises RuntimeError on failure."""
    path = library_path(name, sources, deps)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"host library {name}: build timed out") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library {name}: build failed "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    """Every exported function's signature (the JAX package's `_bind`)."""
    u8 = npc.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = npc.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = npc.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32 = npc.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64 = npc.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    U32 = ctypes.c_uint32
    sigs = {
        "leb128_encode": ([u64, I64, u8, i32], I64),
        "scatter_bytes": ([u8, i64, i64, i64, I64, u8], None),
        "gather_varwidth": ([u8, i32, i64, I64, u8, i32], I64),
        "gather_var_offsets": ([i32, i64, I64, i32], I64),
        "gather_var_bytes": ([u8, i32, i64, I64, i32, u8], None),
        "gather_fixed": ([u8, i64, I64, I32, u8], None),
        "pack_sha_blocks": ([u8, i32, I64, I32, I32, u8, i32], None),
        "hmac_sha256_hex": ([u8, i32, I64, u32, u32, P, u8], None),
        "sha256_block_state": ([u8, u32], None),
        "polyhash_varcol": ([u8, i32, I64, u32, u32, u32, u32], None),
        "rowhash_mix_fixed": ([u32, u32, I64, U32, U32, u32, u32], None),
        "rowhash_mix_var": ([u32, u32, I64, U32, U32, u32, u32], None),
        "rowhash_dict_lanes": ([u32, u32, i32, I64, U32, U32, u32, u32],
                               None),
        "rowhash_accum": ([u32, u32, I64, u32, u32], None),
        "crc32c_batch": ([u8, i64, I64, u32], None),
        "kafka_scan_records": ([u8, I64, i64, I64], I64),
        "avro_decode_flat": ([u8, i64, I64, u8, u8, u8, I64, i64], I64),
        "crc32c_buf": ([u8, I64, U32], U32),
        "kafka_encode_records": ([u8, i64, P, u8, i64, P, P, I64, u8, I64],
                                 I64),
        "pq_decode_fixed": ([u8, I64, I32, I32, I64, I32, P, P], I64),
        "pq_decode_bytearray": ([u8, I64, I32, I64, I32, u8, I64, i32, P,
                                 P, ctypes.POINTER(I32),
                                 ctypes.POINTER(I64)], I64),
        "pq_decode_rowgroup": ([u8, I64, i64, I64], I64),
        "pq_codec_supported": ([I32], I32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(cdll, name)  # AttributeError: the build lacks it
        fn.argtypes = argtypes
        fn.restype = restype
    return cdll


class _ProfiledLib:
    """CDLL proxy: every exported-function call publishes a "this
    thread is inside native symbol S" marker for the sampling profiler
    (stats/profiler.py native_call) — without it, samples landing in
    the C++ code attribute to the CALLER's Python line.

    Everything else forwards to the wrapped CDLL: `hasattr` probes for
    optional symbols and non-callable attributes behave identically.
    The wrapper costs two dict operations per native CALL (calls are
    per-batch/per-column, never per-row)."""

    __slots__ = ("_cdll", "_wrapped")

    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll
        self._wrapped: dict = {}

    def __getattr__(self, name):
        w = self._wrapped.get(name)
        if w is not None:
            return w
        fn = getattr(self._cdll, name)  # AttributeError propagates
        if not callable(fn):
            return fn
        from transferia_tpu_torch.stats.profiler import native_call

        def call(*args, _fn=fn, _name=name):
            with native_call(_name):
                return _fn(*args)

        self._wrapped[name] = call
        return call


def lib() -> _ProfiledLib:
    """The host library, built and bound at first use, behind the
    profiler's native-call markers."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build_host_library("hostops", HOSTOPS_SOURCES,
                                      HOSTOPS_DEPS)
            _lib = _ProfiledLib(_bind(ctypes.CDLL(str(path))))
    return _lib
