"""Order-independent table fingerprints: host half, kernel K10 and its plain twin.

The port of transferia_tpu/ops/rowhash.py.  Every row hashes to two
32-bit lanes, and a table's fingerprint is their order-independent
reduction (per-lane sum mod 2^32, per-lane xor, row count): O(1) state,
mergeable across shards (`FingerprintAggregate.merge`), and with the same
digest text as the reference, so a digest one package recorded parses and
compares equal in the other.

Canonicalization (`prep_batch`, on the host, as in the reference):
- fixed-width columns: the 64-bit pattern; floats widen to float64 first,
  -0.0 becomes +0.0 and every NaN the canonical quiet NaN; bools are 0/1;
  signed integers (and DATE) sign-extend;
- var-width columns: (bytes, offsets), hashed as the SHA-style padded
  block layout of `_pack_var` (0x80 terminator, big-endian bit length);
- dictionary columns: int32 codes plus the pool's per-entry accumulators,
  memoized on the shared `DictPool` (`pool_accumulators`): the column
  never flattens;
- NULLs hash to a per-column constant; each column is seeded by
  crc32(name).

Kernel K10 (csrc/rowhash.cu) computes the lanes on a CUDA tensor:
`rowhash_lanes` (per-row keys, or the reduction into a device
accumulator) and `var_accumulators` (per-pool-entry accumulators).  On a
CPU tensor they run their plain PyTorch versions, `rowhash_lanes_plain`
and `_var_accs_host`, which compute in int64 masked to 32 bits (the CPU
build of torch has no uint32 add, shift or `~`).

The host backend (`row_lanes_host`, `fingerprint_native`) runs the
reference's lane chains in the port's C++ host library (`native/`,
host code: `polyhash_varcol`, `rowhash_mix_fixed`, `rowhash_mix_var`,
`rowhash_dict_lanes`, `rowhash_accum`), as the reference's host backend
does.  It is a placement of the fingerprint, not a version of K10: the
plain versions above stay K10's CPU spec, and the tests hold all three
equal.

Entry points: `TableFingerprinter(backend, device).push/result`,
`DeviceFingerprintProgram(device).dispatch/collect` and
`batch_row_keys(batch, backend, device)`.  Unless `backend="host"`, they
run on the card unless the caller passes `device="cpu"`, and raise
without a card otherwise.  `backend="host"` is the native host lanes;
"device" is K10 on `device` (its plain version on the CPU);
`TableFingerprinter`'s "auto" (the default) is the reference's measured
choice (`TableFingerprinter._choose`): the host lanes until two host
batches were timed, then the device when the link model predicts it
faster per row, re-decided every REPROBE_EVERY batches; without a card
(`device="cpu"`) always the host.  `batch_row_keys`' "auto" is the
device route.
"""

from __future__ import annotations

import ctypes
import functools
import time
import zlib
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from transferia_tpu_torch import native
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.ops.decode import gather_pool_accumulators
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.trace import TELEMETRY

M32 = 0xFFFFFFFF
# lane polynomial bases (odd => invertible mod 2^32) and null sentinels
_P1 = 0x01000193   # FNV-1a prime
_P2 = 0x8DA6B343
_NULL1 = 0xA5A5A5A5
_NULL2 = 0x5A5A5A5A

_CPU = torch.device("cpu")
_KINDS = {"fixed": 0, "var": 1, "dict": 2}

# K10's launch arguments (csrc/rowhash.cu ColDesc, LaneArgs; the source
# static_asserts the same sizes and offsets)
BY_VALUE_COLS = 128  # kByValueCols: wider tables keep descriptors on the card


class ColDesc(ctypes.Structure):
    """One column of a K10 launch: its buffers, size and seeds."""

    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("size", ctypes.c_int64), ("seed1", ctypes.c_uint32),
                ("seed2", ctypes.c_uint32)]


class LaneArgs(ctypes.Structure):
    """K10's `__grid_constant__` argument: up to BY_VALUE_COLS
    descriptors by value, or `dev_cols` pointing at them on the card;
    fixed columns first, then dict, then var ones."""

    _fields_ = [("cols", ColDesc * BY_VALUE_COLS),
                ("dev_cols", ctypes.c_void_p),
                ("r1", ctypes.c_void_p), ("r2", ctypes.c_void_p),
                ("acc", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("n_fixed", ctypes.c_int32), ("n_dict", ctypes.c_int32),
                ("n_var", ctypes.c_int32), ("reduce", ctypes.c_int32)]


def descriptor_route(n_cols: int) -> str:
    """Where a launch's descriptors travel: "by_value" in the kernel's
    parameters up to BY_VALUE_COLS columns, else "device" (one pinned
    copy to the card a launch)."""
    return "by_value" if n_cols <= BY_VALUE_COLS else "device"


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for int64 tensors holding uint32 (b a tensor or an
    int), without any int64 product overflowing."""
    lo = a * (b & 0xFFFF)
    hi = ((a * ((b >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply avalanche (lowbias32) on int64 holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _col_seed(name: str, lane: int) -> int:
    crc = zlib.crc32(name.encode("utf-8", errors="surrogatepass"))
    return (crc + 0x9E3779B9 * (lane + 1)) & M32


@functools.lru_cache(maxsize=64)
def _powers(width: int, base: int) -> torch.Tensor:
    """P^j mod 2^32 for j < width, int64 on the CPU (do not mutate)."""
    pw = torch.ones(1, dtype=torch.int64)
    while pw.numel() < width:
        pw = torch.cat([pw, _mul32(pw, pow(base, pw.numel(), 1 << 32))])
    return pw[:width]


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 holding uint32 bits -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


@dataclass
class FingerprintAggregate:
    """Mergeable order-independent table digest."""

    sum1: int = 0
    sum2: int = 0
    xor1: int = 0
    xor2: int = 0
    count: int = 0

    def merge(self, other: "FingerprintAggregate") -> None:
        self.sum1 = (self.sum1 + other.sum1) & M32
        self.sum2 = (self.sum2 + other.sum2) & M32
        self.xor1 ^= other.xor1
        self.xor2 ^= other.xor2
        self.count += other.count

    def digest(self) -> str:
        return (f"{self.sum1:08x}{self.sum2:08x}"
                f"{self.xor1:08x}{self.xor2:08x}:{self.count}")

    @classmethod
    def parse(cls, digest: str) -> "FingerprintAggregate":
        """Inverse of digest(): per-part digests stored as strings merge
        at read time."""
        hexes, _, count = digest.partition(":")
        if len(hexes) != 32 or not count:
            raise ValueError(f"malformed fingerprint digest: {digest!r}")
        return cls(
            sum1=int(hexes[0:8], 16), sum2=int(hexes[8:16], 16),
            xor1=int(hexes[16:24], 16), xor2=int(hexes[24:32], 16),
            count=int(count),
        )

    @classmethod
    def from_acc(cls, acc: torch.Tensor, count: int
                 ) -> "FingerprintAggregate":
        """From a (4,) int32 accumulator (sum1, sum2, xor1, xor2)."""
        s1, s2, x1, x2 = (int(v) & M32 for v in acc.cpu().tolist())
        return cls(sum1=s1, sum2=s2, xor1=x1, xor2=x2, count=count)

    def __eq__(self, other) -> bool:
        if not isinstance(other, FingerprintAggregate):
            return NotImplemented
        return self.digest() == other.digest()


@dataclass
class _PreppedColumn:
    """Canonical form of one column of one batch, as tensors on one device.

    fixed: bits (N,) int64 holding the canonical uint64 pattern.
    var: data (bytes,) uint8 + offsets (N+1,) int32.
    dict: codes (N,) int32 + the pool's per-entry accumulators acc1/acc2
    (k,) int32 holding uint32.
    validity: (N,) bool or None (all valid).
    """

    name: str
    kind: str                      # "fixed" | "var" | "dict"
    bits: Optional[torch.Tensor] = None
    data: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    acc1: Optional[torch.Tensor] = None
    acc2: Optional[torch.Tensor] = None
    validity: Optional[torch.Tensor] = None

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.bits, self.data, self.offsets, self.codes,
                            self.acc1, self.acc2, self.validity)
                if t is not None]


def _byte_rows(offsets: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(lens, row of each byte, position of each byte in its row, index
    of each byte in the data buffer), int64."""
    off = offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    n = lens.numel()
    row = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=off.device), lens)
    pos = torch.arange(row.numel(), dtype=torch.int64, device=off.device) \
        - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return lens, row, pos, off[:-1][row] + pos


def _pack_var(data: torch.Tensor, offsets: torch.Tensor,
              width: int) -> torch.Tensor:
    """The canonical (N, width) uint8 block matrix of a var-width column:
    each row's bytes, 0x80 at position len, zeros, and the 8 big-endian
    bytes of len*8 ending its own last 64-byte block (the layout of the
    reference's `pack_sha_blocks(prefix_len=0)`)."""
    lens, row, pos, src = _byte_rows(offsets)
    n = lens.numel()
    out = torch.zeros((n, width), dtype=torch.uint8, device=data.device)
    out[row, pos] = data[src]
    rows = torch.arange(n, dtype=torch.int64, device=data.device)
    out[rows, lens] = 0x80
    end = (lens + 9 + 63) // 64 * 64
    for k in range(8):
        out[rows, end - 8 + k] = ((lens * 8) >> (8 * (7 - k))).to(
            torch.uint8)
    return out


def _var_accs_host(data: torch.Tensor, offsets: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both lanes' polynomial accumulators of a var-width column, one per
    row, as (N,) int32 holding uint32: the sum of block[j] * P^j over the
    row's `_pack_var` layout, computed from the real bytes alone (zero
    padding adds nothing).  Plain version of `var_accumulators`."""
    lens, row, pos, src = _byte_rows(offsets)
    n = lens.numel()
    dev = data.device
    end = (lens + 9 + 63) // 64 * 64
    width = int(end.max()) if n else 0
    b = data[src].to(torch.int64)
    out = []
    for base in (_P1, _P2):
        pw = _powers(width, base).to(dev)
        acc = torch.zeros(n, dtype=torch.int64, device=dev)
        acc.index_add_(0, row, _mul32(b, pw[pos]))
        acc += _mul32(pw[lens], 0x80)
        for k in range(8):
            acc += _mul32(pw[end - 8 + k], ((lens * 8) >> (8 * (7 - k)))
                          & 0xFF)
        out.append(_to_i32(acc & M32))
    return out[0], out[1]


def var_accumulators(data: torch.Tensor, offsets: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (or per-pool-entry) accumulators of var-width values.

    data (bytes,) uint8, offsets (N+1,) int32 within data.  Returns two
    (N,) int32 tensors holding uint32.  A CUDA tensor runs kernel K10's
    `trt_var_accumulators`; a CPU tensor runs `_var_accs_host`.  The
    offsets must rise from 0 within data (`_check_offsets`, which
    `pool_accumulators` and `prep_batch` run on the host): the kernel
    clamps each row to the buffer, so bad offsets read nothing outside
    it, but they hash to a meaningless value."""
    dev = data.device
    _build.require(data.dtype == torch.uint8 and data.dim() == 1
                   and data.is_contiguous(),
                   "data must be a contiguous 1-D uint8")
    _build.require(offsets.dtype == torch.int32 and offsets.dim() == 1
                   and offsets.numel() >= 1 and offsets.is_contiguous()
                   and offsets.device == dev,
                   "offsets must be a contiguous (N+1,) int32 on data's "
                   "device")
    if dev.type == "cpu":
        return _var_accs_host(data, offsets)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    n = offsets.numel() - 1
    acc1 = torch.empty(n, dtype=torch.int32, device=dev)
    acc2 = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return acc1, acc2
    lib = _build.library("rowhash")
    rc = lib.trt_var_accumulators(data.data_ptr(), data.numel(),
                                  offsets.data_ptr(), n, acc1.data_ptr(),
                                  acc2.data_ptr(), _build.stream_of(data))
    _build.check(lib, rc, "var_accumulators")
    _build.count_launch("var_accumulators")
    return acc1, acc2


# per-pool accumulator memo key: the accumulators depend only on the pool
# BYTES (the column seed mixes in after the gather), so one pair serves
# every column and batch sharing the pool
_ACC_MEMO_KEY = ("rowhash_accs",)


def pool_accumulators(pool, device: DeviceLike = _CPU
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both lanes' accumulators, one per pool ENTRY, as (k,) int32
    tensors on `device`: what `_var_accs_host` gives a flat row carrying
    the same bytes.  Memoized on the shared DictPool (a memo on another
    device is moved, not recomputed)."""
    dev = torch.device(device)
    memo = pool.memo_get(_ACC_MEMO_KEY)
    if memo is not None:
        if memo[0].device == dev:
            return memo
        accs = (memo[0].to(dev), memo[1].to(dev))
    else:
        failpoint("rowhash.pool_accs")
        # once per shared pool: worth a point event (a chaos fire at the
        # `rowhash.pool_accs` site lands next to it on the active span)
        trace.instant("rowhash_pool_accs", values=pool.n_values)
        data = _host_array(pool.values_data, np.uint8)
        offs = _host_array(pool.values_offsets, np.int32)
        _check_offsets(offs, len(data), "dict pool")
        accs = var_accumulators(torch.from_numpy(data).to(dev),
                                torch.from_numpy(offs).to(dev))
    pool.memo_set(_ACC_MEMO_KEY, accs)
    return accs


def _check_offsets(offsets: np.ndarray, n_bytes: int, what: str) -> None:
    """The kernels read rows through offsets unchecked: they must rise
    from >= 0 and stay within the byte buffer."""
    if len(offsets) and (offsets[0] < 0 or offsets[-1] > n_bytes
                         or bool((offsets[1:] < offsets[:-1]).any())):
        raise ValueError(f"{what}: offsets do not index a {n_bytes}-byte "
                         "buffer in order")


def _host_array(a, dtype=None) -> np.ndarray:
    """A column buffer as a writable contiguous numpy array (a CUDA
    tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.ascontiguousarray(a, dtype=dtype)
    return a if a.flags.writeable else a.copy()


def prep_batch(batch: ColumnBatch, device: DeviceLike = _CPU,
               native: bool = False) -> tuple[list[_PreppedColumn], int]:
    """Canonicalize a batch.  Column buffers become CPU tensors (staged
    onto a card by `_stage`); dict pool accumulators are computed, or
    taken from the pool's memo, on `device`, or on the host backend
    (`pool_accumulators_native`, CPU tensors) when `native`."""
    dev = torch.device(device)
    cols: list[_PreppedColumn] = []
    for name in batch.schema.names():
        col = batch.column(name)
        validity = (None if col.validity is None else torch.from_numpy(
            _host_array(col.validity, np.bool_)))
        if col.is_lazy_dict:
            # dict-native: never touch col.data/col.offsets (that would
            # flatten the pool per row); hash the pool once, gather by code
            pool = col.dict_enc.pool
            codes = _host_array(col.dict_enc.indices, np.int32)
            if len(codes):
                # the kernel's gather clamps: a corrupt code must raise
                # here, not hash a plausible-looking digest
                cmin, cmax = int(codes.min()), int(codes.max())
                if cmin < 0 or cmax >= pool.n_values:
                    raise IndexError(
                        f"column {name}: dict codes [{cmin}, {cmax}] "
                        f"out of range for pool of {pool.n_values} "
                        f"values")
            a1, a2 = (pool_accumulators_native(pool) if native
                      else pool_accumulators(pool, dev))
            TELEMETRY.record_dict_preserved()
            cols.append(_PreppedColumn(
                name=name, kind="dict", codes=torch.from_numpy(codes),
                acc1=a1, acc2=a2, validity=validity))
            continue
        if col.offsets is not None:
            offsets = _host_array(col.offsets, np.int32)
            data = _host_array(col.data, np.uint8)
            _check_offsets(offsets, len(data), f"column {name}")
            cols.append(_PreppedColumn(
                name=name, kind="var", data=torch.from_numpy(data),
                offsets=torch.from_numpy(offsets), validity=validity))
            continue
        data = _host_array(col.data)
        if data.dtype.kind == "f":
            with np.errstate(invalid="ignore"):  # signalling NaN payloads
                data = data.astype(np.float64, copy=True)
            data[data == 0.0] = 0.0          # -0.0 -> +0.0
            data[np.isnan(data)] = np.nan    # canonical quiet NaN
            bits = data.view(np.int64)
        elif data.dtype.kind == "b":
            bits = data.astype(np.int64)
        else:
            bits = data.astype(np.int64, copy=False)
        cols.append(_PreppedColumn(
            name=name, kind="fixed", bits=torch.from_numpy(bits),
            validity=validity))
    return cols, batch.n_rows


def _stage(cols: Sequence[_PreppedColumn], device: torch.device
           ) -> list[_PreppedColumn]:
    """Copy the columns' host tensors to `device` in one transfer, through
    one pinned buffer; PyTorch's host allocator holds that buffer until
    the copy recorded on the stream has run.  On the CPU the columns are
    returned as they are."""
    if device.type == "cpu":
        return list(cols)
    fields = ("bits", "data", "offsets", "codes", "validity")
    layout, total = [], 0
    for c in cols:
        for f in fields:
            t = getattr(c, f)
            if t is not None and t.device.type == "cpu":
                layout.append((c, f, t, total))
                total += -(-t.numel() * t.element_size() // 16) * 16
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    for _, _, t, off in layout:
        nb = t.numel() * t.element_size()
        pinned[off:off + nb].copy_(t.reshape(-1).view(torch.uint8))
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    buf.copy_(pinned, non_blocking=True)
    moved: dict[int, dict] = {}
    for c, f, t, off in layout:
        nb = t.numel() * t.element_size()
        moved.setdefault(id(c), {})[f] = buf[off:off + nb].view(t.dtype)
    return [replace(c, **moved.get(id(c), {})) for c in cols]


# -- kernel K10 and its plain version -----------------------------------------

def _col_desc(c: _PreppedColumn) -> ColDesc:
    ptrs = {"fixed": (c.bits, None, None),
            "var": (c.data, c.offsets, None),
            "dict": (c.codes, c.acc1, c.acc2)}[c.kind]
    # var: the byte buffer's size (no int32 offset reaches past 2^31 - 1);
    # dict: the pool's
    size = (min(c.data.numel(), 2**31 - 1) if c.kind == "var"
            else c.acc1.numel() if c.kind == "dict" else 0)
    return ColDesc(*(_build.ptr(t) for t in ptrs), _build.ptr(c.validity),
                   size, _col_seed(c.name, 0), _col_seed(c.name, 1))


def _check_columns(cols: Sequence[_PreppedColumn], n: int) -> torch.device:
    devices = {t.device for c in cols for t in c.tensors()}
    _build.require(len(devices) <= 1, "columns on several devices")
    for c in cols:
        _build.require(c.kind in _KINDS, f"unknown column kind {c.kind!r}")
        need = {"fixed": (("bits", torch.int64, n),),
                "var": (("data", torch.uint8, None),
                        ("offsets", torch.int32, n + 1)),
                "dict": (("codes", torch.int32, n),
                         ("acc1", torch.int32, None),
                         ("acc2", torch.int32, None))}[c.kind]
        for f, dtype, size in need + (("validity", torch.bool, n),):
            t = getattr(c, f)
            _build.require(
                (t is None and f == "validity") or (
                    t is not None and t.dtype == dtype and t.dim() == 1
                    and t.is_contiguous()
                    and (size is None or t.numel() == size)),
                f"column {c.name}: {f} must be a contiguous 1-D {dtype}"
                + (f" of {size}" if size is not None else ""))
        if c.kind == "dict":
            _build.require(c.acc1.numel() == c.acc2.numel()
                           and (c.acc1.numel() > 0 or n == 0),
                           f"column {c.name}: acc1/acc2 must be one "
                           "non-empty pool's accumulators")
    return devices.pop() if devices else _CPU


def rowhash_lanes(cols: Sequence[_PreppedColumn], n: int,
                  acc: Optional[torch.Tensor] = None
                  ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """The finalized per-row lanes of n rows.

    Without `acc`: returns (r1, r2), (n,) int32 tensors holding uint32.
    With `acc` ((4,) int32 on the columns' device): adds the rows'
    (sum r1, sum r2, xor r1, xor r2) into it in place, mod 2^32.  A CUDA
    tensor runs kernel K10 (`trt_rowhash_lanes`); a CPU tensor runs
    `rowhash_lanes_plain`.  Dict codes must lie in their pool and var
    offsets within their bytes (prep_batch checks both on the host); the
    kernel clamps codes and rows all the same, so it reads nothing
    outside its buffers."""
    dev = _check_columns(cols, n)
    if acc is not None:
        _build.require(acc.dtype == torch.int32 and tuple(acc.shape) == (4,)
                       and acc.is_contiguous()
                       and (not cols or acc.device == dev),
                       "acc must be a contiguous (4,) int32 on the "
                       "columns' device")
        dev = acc.device
    if dev.type == "cpu":
        r1, r2 = rowhash_lanes_plain(cols, n)
        if acc is None:
            return _to_i32(r1), _to_i32(r2)
        _reduce_into(acc, r1, r2)
        return None
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    r1 = r2 = None
    if acc is None:
        r1 = torch.empty(n, dtype=torch.int32, device=dev)
        r2 = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return None if acc is not None else (r1, r2)
    # the kernel takes fixed, then dict, then var columns (the lanes add
    # over columns: any order hashes alike)
    by_kind = {k: [c for c in cols if c.kind == k] for k in _KINDS}
    descs = [_col_desc(c) for k in ("fixed", "dict", "var")
             for c in by_kind[k]]
    args = LaneArgs(n=n, n_fixed=len(by_kind["fixed"]),
                    n_dict=len(by_kind["dict"]), n_var=len(by_kind["var"]),
                    reduce=int(acc is not None), r1=_build.ptr(r1),
                    r2=_build.ptr(r2), acc=_build.ptr(acc))
    if descriptor_route(len(cols)) == "by_value":
        args.cols[:len(descs)] = descs
    else:
        # the pinned copy is held by PyTorch's host allocator until the
        # copy recorded on this stream has run
        table = (ColDesc * len(descs))(*descs)
        dev_cols = torch.frombuffer(bytearray(table), dtype=torch.uint8
                                    ).pin_memory().to(dev, non_blocking=True)
        args.dev_cols = dev_cols.data_ptr()
    lib = _build.library("rowhash")
    rc = lib.trt_rowhash_lanes(ctypes.addressof(args),
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rowhash_lanes")
    _build.count_launch("rowhash_lanes")
    return None if acc is not None else (r1, r2)


def _col_lanes_host(col: _PreppedColumn, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    seeds = (_col_seed(col.name, 0), _col_seed(col.name, 1))
    if col.kind == "fixed":
        lo = col.bits & M32
        hi = (col.bits >> 32) & M32
        hs = [_mix32(_mix32(lo ^ s) + _mix32(hi ^ (~s & M32)) & M32)
              for s in seeds]
    elif col.kind == "dict":
        hs = [_mix32(_to_u32(gather_pool_accumulators(a, col.codes)) ^ s)
              for a, s in zip((col.acc1, col.acc2), seeds)]
    else:
        accs = _var_accs_host(col.data, col.offsets)
        hs = [_mix32(_to_u32(a) ^ s) for a, s in zip(accs, seeds)]
    if col.validity is not None:
        hs = [torch.where(col.validity, h, torch.full_like(h, null ^ s))
              for h, null, s in zip(hs, (_NULL1, _NULL2), seeds)]
    return hs[0], hs[1]


def rowhash_lanes_plain(cols: Sequence[_PreppedColumn], n: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K10: the finalized lanes (r1, r2) as (n,)
    int64 tensors in [0, 2^32), on the columns' device."""
    dev = next((t.device for c in cols for t in c.tensors()), _CPU)
    r1 = torch.zeros(n, dtype=torch.int64, device=dev)
    r2 = torch.zeros(n, dtype=torch.int64, device=dev)
    for col in cols:
        h1, h2 = _col_lanes_host(col, n)
        r1 = (r1 + _mix32(h1)) & M32
        r2 = (r2 + _mix32(h2)) & M32
    return _mix32(r1), _mix32(r2)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return x.sum()  # 0 for an empty x


def _reduce_into(acc: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
                 ) -> None:
    cur = _to_u32(acc)
    sums = torch.stack([r1.sum(), r2.sum()]) + cur[:2]
    xors = torch.stack([_xor_reduce(r1), _xor_reduce(r2)]) ^ cur[2:]
    acc.copy_(_to_i32(torch.cat([sums & M32, xors])))


def row_lanes(cols: Sequence[_PreppedColumn], n_rows: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Finalized per-row lanes as numpy uint32 (r1, r2):
    `(r1[i] << 32) | r2[i]` is a 64-bit content key for row i under the
    fingerprint's canonicalization."""
    r1, r2 = rowhash_lanes(cols, n_rows)
    return (r1.cpu().numpy().view(np.uint32),
            r2.cpu().numpy().view(np.uint32))


def fingerprint_host(cols: Sequence[_PreppedColumn],
                     n_rows: int) -> FingerprintAggregate:
    """The plain version's fingerprint (the host backend on CPU tensors;
    on CUDA tensors, the plain version on the card)."""
    r1, r2 = rowhash_lanes_plain(cols, n_rows)
    acc = torch.zeros(4, dtype=torch.int32, device=r1.device)
    _reduce_into(acc, r1, r2)
    return FingerprintAggregate.from_acc(acc, n_rows)


# -- the host backend: lane chains in the C++ host library -----------------------

def _pow2_width(max_len: int) -> int:
    """Padded row width of a var-width column (>= len + 9, a power of two
    of 64-byte blocks): the reference's power-table width."""
    nb = (max_len + 9 + 63) // 64
    nb = 1 << (nb - 1).bit_length() if nb > 1 else 1
    return nb * 64


@functools.lru_cache(maxsize=64)
def _powers_np(width: int, base: int) -> np.ndarray:
    """`_powers` as a numpy uint32 table (do not mutate)."""
    return _powers(width, base).numpy().astype(np.uint32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """lowbias32 on uint32 (numpy's uint32 product wraps mod 2^32)."""
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _u32(t: torch.Tensor) -> np.ndarray:
    """A CPU int32 tensor holding uint32 bits as a contiguous uint32 array."""
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _var_accs_native(data: np.ndarray, offsets: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Both lanes' accumulators of a var-width column through the host
    library's `polyhash_varcol`: one pass over the real bytes."""
    n = len(offsets) - 1
    a1 = np.empty(n, dtype=np.uint32)
    a2 = np.empty(n, dtype=np.uint32)
    if n == 0:
        return a1, a2
    lens = offsets[1:] - offsets[:-1]
    width = _pow2_width(int(lens.max()))
    native.lib().polyhash_varcol(np.ascontiguousarray(data, dtype=np.uint8),
                                 np.ascontiguousarray(offsets,
                                                      dtype=np.int32),
                                 n, _powers_np(width, _P1),
                                 _powers_np(width, _P2), a1, a2)
    return a1, a2


def pool_accumulators_native(pool) -> tuple[torch.Tensor, torch.Tensor]:
    """`pool_accumulators` on the host backend: the pool's per-entry
    accumulators through `polyhash_varcol`, as (k,) int32 CPU tensors in
    the same memo (the values are identical, so a memo made by either
    route serves both)."""
    memo = pool.memo_get(_ACC_MEMO_KEY)
    if memo is not None:
        return (memo[0].cpu(), memo[1].cpu())
    failpoint("rowhash.pool_accs")
    trace.instant("rowhash_pool_accs", values=pool.n_values)
    data = _host_array(pool.values_data, np.uint8)
    offs = _host_array(pool.values_offsets, np.int32)
    _check_offsets(offs, len(data), "dict pool")
    a1, a2 = _var_accs_native(data, offs)
    accs = (torch.from_numpy(a1.view(np.int32)),
            torch.from_numpy(a2.view(np.int32)))
    pool.memo_set(_ACC_MEMO_KEY, accs)
    return accs


def _col_lanes_native(col: _PreppedColumn, n: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    cdll = native.lib()
    s1, s2 = _col_seed(col.name, 0), _col_seed(col.name, 1)
    h1 = np.empty(n, dtype=np.uint32)
    h2 = np.empty(n, dtype=np.uint32)
    if col.kind == "fixed":
        bits = col.bits.numpy().view(np.uint64)
        cdll.rowhash_mix_fixed(
            (bits & np.uint64(M32)).astype(np.uint32),
            (bits >> np.uint64(32)).astype(np.uint32), n, s1, s2, h1, h2)
    elif col.kind == "dict":
        cdll.rowhash_dict_lanes(_u32(col.acc1), _u32(col.acc2),
                                np.ascontiguousarray(col.codes.numpy()),
                                n, s1, s2, h1, h2)
    else:
        a1, a2 = _var_accs_native(col.data.numpy(), col.offsets.numpy())
        cdll.rowhash_mix_var(a1, a2, n, s1, s2, h1, h2)
    if col.validity is not None:
        valid = col.validity.numpy()
        h1 = np.where(valid, h1, np.uint32(_NULL1 ^ s1))
        h2 = np.where(valid, h2, np.uint32(_NULL2 ^ s2))
    return h1, h2


def row_lanes_host(cols: Sequence[_PreppedColumn], n_rows: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The finalized per-row lanes (r1, r2) as numpy uint32 on the host
    backend: each column's lane chain in the host library, summed by
    `rowhash_accum`.  Columns must be CPU tensors (`prep_batch` on the
    CPU)."""
    r1 = np.zeros(n_rows, dtype=np.uint32)
    r2 = np.zeros(n_rows, dtype=np.uint32)
    if n_rows == 0:
        return r1, r2
    for col in cols:
        h1, h2 = _col_lanes_native(col, n_rows)
        native.lib().rowhash_accum(np.ascontiguousarray(h1),
                                   np.ascontiguousarray(h2), n_rows,
                                   r1, r2)
    return _mix32_np(r1), _mix32_np(r2)


def fingerprint_native(cols: Sequence[_PreppedColumn],
                       n_rows: int) -> FingerprintAggregate:
    """The host backend's fingerprint (the reference's `fingerprint_host`
    over its native lanes)."""
    r1, r2 = row_lanes_host(cols, n_rows)
    return FingerprintAggregate(
        sum1=int(r1.sum(dtype=np.uint64) & M32),
        sum2=int(r2.sum(dtype=np.uint64) & M32),
        xor1=int(np.bitwise_xor.reduce(r1)) if n_rows else 0,
        xor2=int(np.bitwise_xor.reduce(r2)) if n_rows else 0,
        count=n_rows)


# -- device entry points -------------------------------------------------------

def _keys(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    return (r1.astype(np.uint64) << np.uint64(32)) | r2.astype(np.uint64)


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "host", "device"):
        raise ValueError(f"unknown backend {backend!r}")


def batch_row_keys(batch: ColumnBatch, backend: str = "auto",
                   device: DeviceLike = None) -> np.ndarray:
    """64-bit content key per row, `(r1 << 32) | r2`, as numpy uint64.

    backend "host" is the host library's lanes; "device" and "auto" run
    kernel K10 on `device` (CUDA unless the caller passes "cpu", where
    its plain version runs; without a card it raises).  Dict columns key
    code-natively."""
    _check_backend(backend)
    if backend != "host":
        return batch_row_keys_device(batch, device)
    if batch.n_rows == 0:
        return np.empty(0, dtype=np.uint64)
    return _keys(*row_lanes_host(*prep_batch(batch, _CPU, native=True)))


def batch_row_keys_device(batch: ColumnBatch,
                          device: DeviceLike = None) -> np.ndarray:
    """The device key path: one K10 launch in keys mode, r1 and r2 back
    to the host, keys assembled there."""
    dev = resolve_device(device)
    if batch.n_rows == 0:
        return np.empty(0, dtype=np.uint64)
    cols, n = prep_batch(batch, dev)
    # row_lanes' D2H copy waits for the staging copy and the kernel
    return _keys(*row_lanes(_stage(cols, dev), n))


class DeviceFingerprintProgram:
    """The device twin of fingerprint_host.

    Each dispatch stages one batch's columns in one host-to-device copy
    and launches K10 in reduce mode, which adds into one (4,) accumulator
    on the device; nothing waits.  collect() synchronizes once and reads
    16 bytes back.
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._acc: Optional[torch.Tensor] = None
        self._count = 0

    def dispatch(self, cols: Sequence[_PreppedColumn], n_rows: int) -> None:
        """Launch one batch asynchronously; its result lands in collect()."""
        if self._acc is None:
            self._acc = torch.zeros(4, dtype=torch.int32, device=self.device)
        rowhash_lanes(_stage(cols, self.device), n_rows, self._acc)
        self._count += n_rows

    def collect(self) -> FingerprintAggregate:
        """Wait for every dispatched launch; the merged partials."""
        if self._acc is None:
            return FingerprintAggregate()
        agg = FingerprintAggregate.from_acc(self._acc, self._count)
        self._acc, self._count = None, 0
        return agg


def _row_bytes(batch: ColumnBatch) -> int:
    """The reference's bytes a row for the chooser's link model: a var
    column's padded width, 8 for every other column."""
    total = 0
    for name in batch.schema.names():
        col = batch.column(name)
        if not col.is_lazy_dict and col.offsets is not None:
            offs = _host_array(col.offsets, np.int64)
            lens = offs[1:] - offs[:-1]
            total += _pow2_width(int(lens.max()) if len(lens) else 0)
        else:
            total += 8
    return total


class TableFingerprinter:
    """Streaming fingerprint over batches, backend chosen by measurement.

    backend "host" runs the host library's lanes; "device" runs
    DeviceFingerprintProgram on `device` (K10 on a card, its plain
    version with device="cpu"); "auto" (the reference's `_choose`) times
    the host lanes on the first batches and predicts the device from the
    link profile: the reduction's output is 16 bytes, so the device pays
    whenever H2D keeps up and batches amortize the launch.  Unless
    backend is "host", `device` is resolved at construction: CUDA by
    default, and without a card that raises unless the caller passes
    device="cpu" (where "auto" is always the host, as the reference's is
    with JAX on the CPU).
    """

    # re-evaluate the decision periodically: links drift, and a decision
    # pinned off one skewed sample would fix a bad backend for a whole
    # table scan
    REPROBE_EVERY = 256

    def __init__(self, backend: str = "auto", device: DeviceLike = None):
        _check_backend(backend)
        self.backend = backend
        self._agg = FingerprintAggregate()
        self.device = None if backend == "host" else resolve_device(device)
        self._device: Optional[DeviceFingerprintProgram] = (
            DeviceFingerprintProgram(self.device) if backend == "device"
            else None)
        self._host_ns_row = -1.0
        # the link model's ns/row for the card at the last decision
        self._device_ns_row = -1.0
        self._host_samples = 0
        self._batch_no = 0
        self._decided: Optional[str] = None
        # every batch's placement, in push order (read by tests and the
        # chip's checksum phase)
        self.choices: list[str] = []

    def _accel_available(self) -> bool:
        """The device pays only on a real accelerator."""
        return self.device is not None and self.device.type == "cuda"

    def _choose(self, n_rows: int, row_bytes: int) -> str:
        if self.backend in ("host", "device"):
            return self.backend
        if (self._decided is not None
                and self._batch_no % self.REPROBE_EVERY != 0):
            return self._decided
        # two host samples first: the first carries one-off warm-up (the
        # host library's build, cold caches) and is never recorded
        if self._host_samples < 2 or not self._accel_available():
            return "host"
        from transferia_tpu_torch.ops.linkprobe import probe_link

        link = probe_link(self.device)
        pred_s = (2 * link.launch_overhead_s
                  + n_rows * row_bytes / link.h2d_bytes_per_s
                  + n_rows / 20e6)
        pred_ns = pred_s * 1e9 / max(n_rows, 1)
        self._device_ns_row = pred_ns
        self._decided = ("device" if pred_ns < self._host_ns_row
                         else "host")
        return self._decided

    def push(self, batch: ColumnBatch) -> None:
        if batch.n_rows == 0:
            return
        self._batch_no += 1
        choice = self._choose(batch.n_rows, _row_bytes(batch))
        self.choices.append(choice)
        if choice == "device":
            if self._device is None:
                self._device = DeviceFingerprintProgram(self.device)
            self._device.dispatch(*prep_batch(batch, self._device.device))
            return
        cols, n = prep_batch(batch, _CPU, native=True)
        t0 = time.perf_counter()
        self._agg.merge(fingerprint_native(cols, n))
        ns = (time.perf_counter() - t0) * 1e9 / batch.n_rows
        self._host_samples += 1
        if self._host_samples == 1:
            return  # warm-up: measured, not recorded
        self._host_ns_row = (ns if self._host_ns_row < 0
                             else 0.7 * self._host_ns_row + 0.3 * ns)

    def ns_per_row(self) -> dict:
        """The ns/row behind auto's last decision: the host lanes' as
        measured, the card's as the link model predicts (-1 before)."""
        return {"host": self._host_ns_row, "device": self._device_ns_row}

    def result(self) -> FingerprintAggregate:
        if self._device is not None:
            self._agg.merge(self._device.collect())
        return self._agg
