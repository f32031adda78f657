"""Build the port's CUDA kernels and bind them to Python.

Each source under ``transferia_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ctypes.  All sources build at first use, in parallel (one ``nvcc``
per source), into ``build/torch_kernels/`` at the root of the checkout;
a library's file name carries a digest of its source and flags, so an
edited source rebuilds and an unchanged one is reused.  There is no
``--use_fast_math``: the predicate kernel relies on IEEE NaN compares.

A kernel's C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` raises on anything but success.  Wrappers
count their launches here (`count_launch`), so a run can show which
kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_UL, _U = ctypes.c_ulonglong, ctypes.c_uint

# library -> C function -> argtypes (every function returns a cudaError_t)
SIGNATURES: dict[str, dict[str, list]] = {
    "sha256_hmac": {
        # blocks, n_blocks, n_rows, max_blocks, init, outer, out, stream
        "trt_sha256_hmac": [_P, _P, _I, _I, _P, _P, _P, _P],
    },
    "pred_decode": {
        # mode, words, n_words, n, bw, base, mins, frame, scratch,
        # scratch_tiles, ticket_base, epoch, out, stream
        "trt_pred_decode": [_I, _P, _I, _L, _I, _I, _P, _I, _P, _I, _UL,
                            _U, _P, _P],
        # words, n_words, n, bw, pool, k, staged, carry_in, carry_out,
        # out, stream
        "trt_dict_decode": [_P, _I, _L, _I, _P, _I, _I, _P, _P, _P, _P],
    },
    "pred3vl_mask": {
        # PredArgs (a host struct, passed on by value), stream
        "trt_pred3vl_mask": [_P, _P],
    },
    "rowhash": {
        # LaneArgs (a host struct, passed on by value), stream
        "trt_rowhash_lanes": [_P, _P],
        # data, n_bytes, offsets, n, acc1, acc2, stream
        "trt_var_accumulators": [_P, _L, _P, _L, _P, _P, _P],
    },
    "raggedpack": {
        # data, n_data, offsets, n_rows, bucket, max_blocks, blocks,
        # n_blocks, stream
        "trt_ragged_pack": [_P, _L, _P, _I, _I, _I, _P, _P, _P],
    },
    "mesh": {
        # mode, digests, n_mats, n_rows, n_shards, keep, valid,
        # bool_layout, ages, scores, scores_f64, keep_out, scores_out,
        # out, next, next_words, stream
        "trt_shard_hist": [_I, _P, _I, _L, _I, _P, _P, _I, _P, _P, _I, _P,
                           _P, _P, _P, _I, _P],
        # table, n_values, codes, n_rows, out, stream
        "trt_digest_gather": [_P, _I, _P, _L, _P, _P],
    },
    "lambda_select": {
        # ids, region, n, threshold, out, stream
        "trt_region_sign_flip": [_P, _P, _L, _I, _P, _P],
    },
    "probe": {
        "trt_empty_launch": [_P],
    },
}

# kernels whose launches are counted (the probe is a timer, not a kernel
# of a data path)
KERNELS = ("sha256_hmac", "pred_decode", "pred3vl_mask", "rowhash_lanes",
           "var_accumulators", "dict_decode", "ragged_pack", "shard_hist",
           "digest_gather", "region_sign_flip")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's stderr (ptxas register/spill report)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_builds: dict[str, BuildInfo] = {}
_launches: dict[str, int] = {name: 0 for name in KERNELS}
_launch_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> dict[str, BuildInfo]:
    """Build every missing library (one nvcc per source, all at once)
    and load them all; returns what each build took."""
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return dict(_builds)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        for name in SIGNATURES:
            path = _lib_path(name)
            if path.exists():
                _builds[name] = BuildInfo(path, 0.0, "")
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            pending[name] = (proc, tmp, path, time.perf_counter())
        failures = []
        for name, (proc, tmp, path, t0) in pending.items():
            out, err = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{name}.cu (rc={proc.returncode}):\n"
                                f"{out}{err}")
                continue
            os.replace(tmp, path)
            _builds[name] = BuildInfo(path, seconds, err)
            _record_build(name, seconds)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
        for name, fns in SIGNATURES.items():
            lib = ctypes.CDLL(str(_builds[name].path))
            for fn, argtypes in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.trt_error_string.argtypes = [ctypes.c_int]
            lib.trt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return dict(_builds)


def _record_build(name: str, seconds: float) -> None:
    """One `nvcc` build is the port's compile event: it stands where the
    reference's `xla_compile` instant and `TELEMETRY.record_compile`
    (jax's backend-compile hook, `stats/trace.py::install_jit_hooks`)
    do, so a build inside a measured window shows in the trace."""
    from transferia_tpu_torch.stats import trace

    trace.TELEMETRY.record_compile(seconds)
    trace.instant("kernel_build", source=f"{name}.cu",
                  seconds=round(seconds, 4))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (building all on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        msg = lib.trt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on a tensor's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def require(cond: bool, what: str) -> None:
    """Argument check of a kernel wrapper."""
    if not cond:
        raise ValueError(what)
