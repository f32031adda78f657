"""The SR fan-in user function and its kernel K15.

The port's counterpart of bench.py:1006-1018 `bench_lambda`, the user
jax.jit program that BASELINE config #5 (examples/kafka_sr2ch.yaml,
bench.py `measure_kafka_sr2ch`) hands the lambda transformer:
``jnp.where(region < 400, ids, -ids)``.  The JAX package runs without
x64, so jax.jit sees the int64 ``id`` column as int32: it keeps the low
32 bits, negates with int32 wrap and returns int32, and the lambda
transformer re-types the column INT32.  The port gives the same column.

`region_sign_flip` launches K15 (csrc/lambda_select.cu) on CUDA tensors
and runs `region_sign_flip_plain`, its plain PyTorch version, on CPU
tensors.  Which of the two runs follows where the lambda transformer put
the function's inputs (transform/plugins/lambda_tf.py: the host strategy
hands it CPU tensors, the device strategy tensors on the card); it is
never a fallback.  `bench_lambda` resolves as
``"transferia_tpu_torch.ops.lambdas:bench_lambda"``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from transferia_tpu_torch.ops import _build

REGION_THRESHOLD = 400  # bench.py:1015


def region_sign_flip(ids: torch.Tensor, region: torch.Tensor,
                     threshold: int = REGION_THRESHOLD) -> torch.Tensor:
    """(n,) int32: the low 32 bits of `ids` where `region < threshold`,
    their int32 negation (wrapping) elsewhere.

    ids: (n,) int64; region: (n,) int32 on the same device.  A CUDA
    tensor launches K15; a CPU tensor runs `region_sign_flip_plain`."""
    dev = ids.device
    _build.require(ids.dtype == torch.int64 and ids.dim() == 1
                   and ids.is_contiguous(),
                   "ids must be a contiguous 1-D int64")
    _build.require(region.dtype == torch.int32 and region.dim() == 1
                   and region.is_contiguous() and region.device == dev
                   and region.numel() == ids.numel(),
                   "region must be a contiguous int32 of ids' length on "
                   "ids' device")
    _build.require(-2**31 <= threshold < 2**31,
                   f"threshold {threshold} is not an int32")
    if dev.type == "cpu":
        return region_sign_flip_plain(ids, region, threshold)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    n = ids.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.library("lambda_select")
    rc = lib.trt_region_sign_flip(ids.data_ptr(), region.data_ptr(), n,
                                  int(threshold), out.data_ptr(),
                                  _build.stream_of(ids))
    _build.check(lib, rc, "region_sign_flip")
    _build.count_launch("region_sign_flip")
    return out


def _low32(x: torch.Tensor) -> torch.Tensor:
    """The signed value of an int64's low 32 bits, still in int64."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def region_sign_flip_plain(ids: torch.Tensor, region: torch.Tensor,
                           threshold: int = REGION_THRESHOLD
                           ) -> torch.Tensor:
    """Plain PyTorch version of K15: the cast and the wrapping negation
    computed exactly in int64 (-(-2^31) is 2^31, whose low 32 bits are
    -2^31 again)."""
    low = _low32(ids.to(torch.int64))
    flipped = torch.where(region < threshold, low, -low)
    return _low32(flipped).to(torch.int32)


def bench_lambda(arrays: Mapping) -> dict:
    """User lambda for the SR fan-in config: sign-flip ids outside the
    region window (bench.py:1006-1018).  `arrays` maps column names to
    tensors (or arrays); returns ``{"id": int32 tensor}`` on the inputs'
    device.  Integer columns of another width are brought to the
    kernel's types first: ids widen to int64, a region keeps its low 32
    bits, as jax.jit without x64 keeps them."""
    ids = torch.as_tensor(arrays["id"])
    region = torch.as_tensor(arrays["region"])
    for name, t in (("id", ids), ("region", region)):
        _build.require(not t.dtype.is_floating_point
                       and not t.dtype.is_complex
                       and t.dtype != torch.bool,
                       f"bench_lambda: column {name!r} must be an integer "
                       f"column, got {t.dtype}")
    if region.dtype != torch.int32:
        region = _low32(region.to(torch.int64)).to(torch.int32)
    return {"id": region_sign_flip(ids.to(torch.int64).contiguous(),
                                   region.contiguous())}
