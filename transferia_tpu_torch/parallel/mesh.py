"""Device mesh and the mesh-sharded transform step (kernel K13).

The port of transferia_tpu/parallel/mesh.py.  The reference's mesh is
one process driving every device of `jax.devices()`, so the port's is a
single-process mesh too: a (data, model) array of torch devices, one
shard per entry.  Shards on one device are virtual (each runs on its own
CUDA stream over views of one staged batch); shards on several cards
are the same code, each on its own card.  A JAX `psum` becomes a sum of
the shards' partials on the mesh's first device.

`sharded_transform_step(mesh)` is the flagship step of the reference
(__graft_entry__.py): HMAC-mask the columns, keep rows with `ages >= 0`
and a finite float32 score, cast the scores to float32, and count the
kept rows of every column per target shard (`digest word 0 % n_shards`,
what a sharded ClickHouse writer balances inserts by).  Columns split
over `model`, rows over `data`; each shard runs one K-A launch over its
`C_local x N_local` rows, then kernel K13 (`shard_hist_step`,
csrc/mesh.cu `trt_shard_hist`).  `shard_hist_fused` is the same kernel
in the mode the fused mesh program uses (parallel/fusedmesh.py, K14).
On CPU tensors both run their plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.ops.dispatch import stage_h2d_counted
from transferia_tpu_torch.ops.sha256 import _hmac_key_states, hmac_device_core
from transferia_tpu_torch.runtime.device import (
    DeviceLike,
    default_mesh_devices,
    resolve_device,
)

MAX_SHARDS = 4096  # csrc/mesh.cu kMaxShards
BALLOT_SHARDS = 32  # csrc/mesh.cu kBallotShards: above it, shared atomics
_M32 = 0xFFFFFFFF


class Mesh:
    """A (data, model) array of torch devices, one shard per entry.

    Shard s of a row-sharded array is `devices.flat[s]` (data-major, as
    a JAX PartitionSpec over ("data", "model") orders them)."""

    def __init__(self, devices: np.ndarray,
                 axis_names: tuple[str, str] = ("data", "model")):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> list[torch.device]:
        return list(self.devices.flat)

    def shards_by_device(self) -> dict[torch.device, list[int]]:
        """Physical device -> the flat indices of the shards it hosts."""
        out: dict[torch.device, list[int]] = {}
        for s, dev in enumerate(self.devices.flat):
            out.setdefault(dev, []).append(s)
        return out


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None,
              device: DeviceLike = None) -> Mesh:
    """A 2D ('data', 'model') mesh over the default mesh devices of
    `device` (runtime/device.py `default_mesh_devices`) or over
    `devices`: 'model' is 2 when the count is even and at least 4, else
    1; the rest goes to 'data'."""
    if devices is None:
        devices = default_mesh_devices(device)
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    model = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // model
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[:data * model]
    return Mesh(grid.reshape(data, model), ("data", "model"))


# -- staging a sharded batch -----------------------------------------------------

def stage_sharded(mesh: Mesh, entries: Sequence[tuple[object, str]],
                  copy_streams: dict, raw_equiv_bytes: int
                  ) -> tuple[list[list], list]:
    """Stage host arrays on the mesh: once per physical device.

    entries: (host array or tuple, kind) with kind "shard" (leading axis
    = flat shard index), "data" (leading axis = data index, shared by
    the shard's model row) or "rep" (replicated whole).  A device that
    hosts every shard gets the whole arrays, and each shard views its
    rows of them; a device hosting some shards gets only their slices.
    A shard sees its rows of a sharded array with a leading axis of 1,
    as shard_map hands each device its block.  Returns (per shard: its
    arrays in entry order, per shard: the event its staging recorded or
    None on the CPU, the bytes staged).  The bytes count once against
    `raw_equiv_bytes` (ops/dispatch.py `dispatch_bytes`), one `TELEMETRY`
    transfer a physical device's staging."""
    n = mesh.size
    model = mesh.shape["model"]

    def pick(a, kind, s):
        if kind == "shard":
            return a[s:s + 1]
        if kind == "data":
            return a[s // model:s // model + 1]
        return a

    views: list[list] = [[] for _ in range(n)]
    events: list = [None] * n
    raw = raw_equiv_bytes
    staged_bytes = 0
    for dev, shards in mesh.shards_by_device().items():
        groups = ([shards] if len(shards) == n else [[s] for s in shards])
        for group in groups:
            host = tuple(a if len(group) == n else pick(a, kind, group[0])
                         for a, kind in entries)
            staged, event, nbytes = stage_h2d_counted(
                host, dev, copy_streams.get(dev), raw_equiv_bytes=raw,
                what="mesh")
            staged_bytes += nbytes
            raw = 0
            for s in group:
                views[s] = [pick(t, kind, s) if len(group) == n else t
                            for t, (_, kind) in zip(staged, entries)]
                events[s] = event
    return views, events, staged_bytes


def shard_streams(mesh: Mesh) -> tuple[list, dict]:
    """One compute stream per shard and one copy stream per physical
    device on CUDA; Nones and {} on the CPU."""
    compute = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in mesh.flat_devices()]
    copy = {d: torch.cuda.Stream(d) for d in mesh.shards_by_device()
            if d.type == "cuda"}
    return compute, copy


def on_stream(stream):
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def wait_for_caller(mesh: Mesh, compute: list, copy: dict) -> None:
    """Make work the caller enqueued on each device's current stream
    visible to the mesh's streams."""
    for dev in mesh.shards_by_device():
        if dev.type != "cuda":
            continue
        current = torch.cuda.current_stream(dev)
        copy[dev].wait_stream(current)
        for st, d in zip(compute, mesh.flat_devices()):
            if d == dev:
                st.wait_stream(current)


def sum_partials(partials: list[torch.Tensor], dev0: torch.device,
                 stream, done: list) -> torch.Tensor:
    """The psum: every shard's int32 partial summed on the first device,
    on `stream` after every shard's `done` event."""
    with on_stream(stream):
        if stream is not None:
            for ev in done:
                stream.wait_event(ev)
        return torch.stack([p.to(dev0) for p in partials]).sum(
            0, dtype=torch.int32)


# -- kernel K13/K14's shard histogram and its plain versions ---------------------

class HistOutputs:
    """The histogram's zeroed outputs, one pending buffer per (device,
    stream).

    A launch adds into the pending buffer and zeroes a new one that the
    next launch on the stream adds into, so no launch needs a fill: only
    the first on a stream (or the first with more bins than its stream's
    buffer holds) takes a buffer made with zeros.  Launches on one stream
    run in order, and two streams never share a buffer, so two histograms
    can be in flight at once.  A launch that raises drops its stream's
    pending buffer (the kernel may have run before the error came back),
    so the next launch there starts from new zeros."""

    MIN_WORDS = BALLOT_SHARDS + 1

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict[tuple[torch.device, int], torch.Tensor] = {}

    @contextlib.contextmanager
    def launch(self, device: torch.device, stream: int, words: int
               ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """(out: zeros of at least `words`, next: an empty buffer of the
        same size for the launch to zero), held under a lock until the
        launch is enqueued; `next` becomes the stream's pending buffer if
        the body returns, and the stream has none if it raises."""
        with self._lock:
            key = (device, stream)
            out = self._pending.pop(key, None)
            if out is None or out.numel() < words:
                out = torch.zeros(max(words, self.MIN_WORDS,
                                      0 if out is None else out.numel()),
                                  dtype=torch.int32, device=device)
            nxt = torch.empty_like(out)
            yield out, nxt
            self._pending[key] = nxt


_HIST_OUTPUTS = HistOutputs()


def _launch_hist(mode: int, digests: torch.Tensor, n_mats: int, n: int,
                 n_shards: int, keep, valid, bool_layout: bool, ages, scores,
                 keep_out, scores_out) -> torch.Tensor:
    """One `trt_shard_hist` launch; returns its (n_shards + 1,) partial."""
    dev = digests.device
    stream = _build.stream_of(digests)
    lib = _build.library("mesh")
    with _HIST_OUTPUTS.launch(dev, stream, n_shards + 1) as (out, nxt):
        rc = lib.trt_shard_hist(
            mode, digests.data_ptr(), n_mats, n, n_shards, _build.ptr(keep),
            _build.ptr(valid), int(bool_layout), _build.ptr(ages),
            _build.ptr(scores),
            int(scores is not None and scores.dtype == torch.float64),
            _build.ptr(keep_out), _build.ptr(scores_out), out.data_ptr(),
            nxt.data_ptr(), nxt.numel(), stream)
        _build.check(lib, rc, "shard_hist")
    _build.count_launch("shard_hist")
    return out[:n_shards + 1]


def check_shards(n_shards: int) -> None:
    _build.require(1 <= n_shards <= MAX_SHARDS,
                   f"n_shards must be in [1, {MAX_SHARDS}], not {n_shards}")


def _check_mask(m: torch.Tensor, n: int, dev, what: str) -> bool:
    """A keep/valid source: (n,) bool or (n/32,) packed int32 words.
    Returns True for the bool layout."""
    _build.require(m.device == dev and m.dim() == 1 and m.is_contiguous(),
                   f"{what} must be a contiguous 1-D tensor on the "
                   f"digests' device")
    if m.dtype == torch.bool:
        _build.require(m.numel() >= n, f"{what} has fewer than {n} rows")
        return True
    _build.require(m.dtype == torch.int32 and m.numel() * 32 >= n,
                   f"{what} must be bool or packed int32 words over "
                   f"{n} rows")
    return False


def shard_hist_fused(digest0: torch.Tensor, n_shards: int,
                     valid: torch.Tensor,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14's shard histogram: (n_shards + 1,) int32, the count of kept
    rows per `uint32(digest0[r, 0]) % n_shards`, then the kept count.

    digest0: (n, 8) int32 digest words of the first masked column;
    valid: the run validity, keep: the predicate's mask (None = no
    predicate), both (n,) bool or both packed int32 words.  A row
    counts when valid and kept.  CUDA tensors run kernel K13/K14
    (`trt_shard_hist`, fused mode); CPU tensors the plain version."""
    dev = digest0.device
    check_shards(n_shards)
    _build.require(digest0.dtype == torch.int32 and digest0.dim() == 2
                   and digest0.shape[1] == 8 and digest0.is_contiguous(),
                   "digest0 must be a contiguous (n, 8) int32")
    n = digest0.shape[0]
    bool_layout = _check_mask(valid, n, dev, "valid")
    if keep is not None:
        _build.require(_check_mask(keep, n, dev, "keep") == bool_layout,
                       "keep and valid must share one layout")
    if dev.type == "cpu":
        return shard_hist_fused_plain(digest0, n_shards, valid, keep)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    return _launch_hist(0, digest0, 1, n, n_shards, keep, valid,
                        bool_layout, None, None, None, None)


def shard_hist_step(digests: torch.Tensor, ages: torch.Tensor,
                    scores: torch.Tensor, n_shards: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13's step: (partial (n_shards + 1,) int32, keep (N,) bool,
    scores_f32 (N,) float32).

    digests: (C, N, 8) int32; ages: (N,) int32; scores: (N,) float32 or
    float64.  scores_f32 = float32(scores); keep = ages >= 0 &
    isfinite(scores_f32); the partial counts every column's kept rows
    per `uint32(digests[c, r, 0]) % n_shards`, then Σ keep.  CUDA
    tensors run kernel K13 (`trt_shard_hist`, step mode); CPU tensors
    the plain version."""
    dev = digests.device
    check_shards(n_shards)
    _build.require(digests.dtype == torch.int32 and digests.dim() == 3
                   and digests.shape[0] >= 1 and digests.shape[2] == 8
                   and digests.is_contiguous(),
                   "digests must be a contiguous (C, N, 8) int32")
    n = digests.shape[1]
    _build.require(ages.dtype == torch.int32 and tuple(ages.shape) == (n,)
                   and ages.is_contiguous() and ages.device == dev,
                   "ages must be a contiguous (N,) int32 on the digests' "
                   "device")
    _build.require(scores.dtype in (torch.float32, torch.float64)
                   and tuple(scores.shape) == (n,)
                   and scores.is_contiguous() and scores.device == dev,
                   "scores must be a contiguous (N,) float32/float64 on "
                   "the digests' device")
    if dev.type == "cpu":
        return shard_hist_step_plain(digests, ages, scores, n_shards)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    scores_f32 = torch.empty(n, dtype=torch.float32, device=dev)
    out = _launch_hist(1, digests, digests.shape[0], n, n_shards, None, None,
                       False, ages, scores, keep, scores_f32)
    return out, keep, scores_f32


def _rows_of(mask: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool from a bool mask or packed int32 words."""
    if mask.dtype == torch.bool:
        return mask[:n]
    r = torch.arange(n, device=mask.device)
    return ((mask.to(torch.int64)[r >> 5] >> (r & 31)) & 1).bool()


def _hist_plain(word0: torch.Tensor, weights: torch.Tensor,
                n_shards: int) -> torch.Tensor:
    bins = (word0.to(torch.int64) & _M32) % n_shards
    return torch.zeros(n_shards, dtype=torch.int64,
                       device=word0.device).index_add_(0, bins, weights)


def shard_hist_fused_plain(digest0: torch.Tensor, n_shards: int,
                           valid: torch.Tensor,
                           keep: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of `shard_hist_fused`."""
    n = digest0.shape[0]
    k = _rows_of(valid, n)
    if keep is not None:
        k = k & _rows_of(keep, n)
    w = k.to(torch.int64)
    return torch.cat([_hist_plain(digest0[:, 0], w, n_shards),
                      w.sum().reshape(1)]).to(torch.int32)


def shard_hist_step_plain(digests: torch.Tensor, ages: torch.Tensor,
                          scores: torch.Tensor, n_shards: int
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain PyTorch version of `shard_hist_step`."""
    scores_f32 = scores.to(torch.float32)
    keep = (ages >= 0) & torch.isfinite(scores_f32)
    c = digests.shape[0]
    w = keep.to(torch.int64).expand(c, -1).reshape(-1)
    hist = _hist_plain(digests[:, :, 0].reshape(-1), w, n_shards)
    partial = torch.cat([hist, keep.to(torch.int64).sum().reshape(1)])
    return partial.to(torch.int32), keep, scores_f32


# -- the sharded transform step ------------------------------------------------------

class ShardedTransformStep:
    """`sharded_transform_step(mesh, ...)`: call it with host arrays
    (blocks (C, N, max_blocks*64) uint8, n_blocks (C, N) int32, ages
    (N,) int32, scores (N,) float) to get, on the mesh's first device,
    (digests (C, N, 8) int32 with the uint32 bits, keep (N,) bool,
    scores_f32 (N,), hist (n_shards,) int32 over every row and column
    shard, total kept rows () int32)."""

    def __init__(self, mesh: Mesh, max_blocks: int = 2, n_shards: int = 16,
                 key: bytes = b"mask-key"):
        check_shards(n_shards)
        self.mesh = mesh
        self.max_blocks = max_blocks
        self.n_shards = n_shards
        self._states = {d: _hmac_key_states(bytes(key), d)
                        for d in mesh.shards_by_device()}
        self._compute, self._copy = shard_streams(mesh)

    def __call__(self, blocks, n_blocks, ages, scores):
        mesh = self.mesh
        d_n, m_n = mesh.shape["data"], mesh.shape["model"]
        blocks = np.asarray(blocks, dtype=np.uint8)
        n_cols, n_rows, width = blocks.shape
        if n_cols % m_n or n_rows % d_n:
            raise ValueError(
                f"{n_cols} columns x {n_rows} rows do not split over a "
                f"(data={d_n}, model={m_n}) mesh")
        if width != self.max_blocks * 64:
            raise ValueError(f"blocks are {width} bytes wide, not "
                             f"{self.max_blocks * 64}")
        c_l, n_l = n_cols // m_n, n_rows // d_n
        n_blocks = np.asarray(n_blocks).astype(np.int32, copy=False)
        ages = np.asarray(ages).astype(np.int32, copy=False)
        scores = np.asarray(scores)
        if scores.dtype not in (np.float32, np.float64):
            scores = scores.astype(np.float64)
        if n_blocks.shape != (n_cols, n_rows) or ages.shape != (n_rows,) \
                or scores.shape != (n_rows,):
            raise ValueError("n_blocks must be (C, N), ages and scores (N,)")
        # shard-major layout: shard (i, j) = flat i*model + j holds
        # columns j*C_l.. and rows i*N_l.., contiguous for one K-A launch
        blk = np.ascontiguousarray(
            blocks.reshape(m_n, c_l, d_n, n_l, width)
            .transpose(2, 0, 1, 3, 4)).reshape(d_n * m_n, c_l * n_l, width)
        nbk = np.ascontiguousarray(
            n_blocks.reshape(m_n, c_l, d_n, n_l).transpose(2, 0, 1, 3)
        ).reshape(d_n * m_n, c_l * n_l)
        entries = ((blk, "shard"), (nbk, "shard"),
                   (ages.reshape(d_n, n_l), "data"),
                   (np.ascontiguousarray(scores).reshape(d_n, n_l), "data"))
        wait_for_caller(mesh, self._compute, self._copy)
        views, events, _ = stage_sharded(
            mesh, entries, self._copy,
            blk.nbytes + nbk.nbytes + ages.nbytes + scores.nbytes)
        results, done = [], []
        for s, dev in enumerate(mesh.flat_devices()):
            stream = self._compute[s]
            with on_stream(stream):
                if stream is not None:
                    stream.wait_event(events[s])
                    for t in views[s]:
                        t.record_stream(stream)
                b, nb, a, sc = (v[0] for v in views[s])
                inner, outer = self._states[dev]
                dig = hmac_device_core(b, nb, inner, outer, self.max_blocks)
                part, keep, s32 = shard_hist_step(
                    dig.view(c_l, n_l, 8), a, sc, self.n_shards)
                results.append((dig, part, keep, s32))
                if stream is not None:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    done.append(ev)
        return self._assemble(results, done, n_cols, n_rows, c_l, n_l)

    def _assemble(self, results, done, n_cols, n_rows, c_l, n_l):
        """The global outputs on the first device, after every shard:
        digests in (C, N, 8) order, keep and scores from the model-0
        shards, the psums."""
        mesh = self.mesh
        d_n, m_n = mesh.shape["data"], mesh.shape["model"]
        dev0 = mesh.flat_devices()[0]
        total = sum_partials([r[1] for r in results], dev0,
                             self._compute[0], done)
        with on_stream(self._compute[0]):
            digests = torch.empty((m_n, c_l, d_n, n_l, 8), dtype=torch.int32,
                                  device=dev0)
            for s, (dig, _, _, _) in enumerate(results):
                i, j = divmod(s, m_n)
                digests[j, :, i].copy_(dig.view(c_l, n_l, 8))
            keep = torch.cat([results[i * m_n][2].to(dev0)
                              for i in range(d_n)])
            scores = torch.cat([results[i * m_n][3].to(dev0)
                                for i in range(d_n)])
            # total kept rows: psum over 'data' of one model column
            kept = sum(results[i * m_n][1][self.n_shards].to(dev0)
                       for i in range(d_n))
            out = (digests.view(n_cols, n_rows, 8), keep, scores,
                   total[:self.n_shards], kept.to(torch.int32))
        reduce_stream = self._compute[0]
        if reduce_stream is not None:
            # the shards' tensors were read on the reduce stream, and the
            # outputs will be on the caller's
            for r in results[1:]:
                for t in r:
                    t.record_stream(reduce_stream)
            current = torch.cuda.current_stream(dev0)
            current.wait_stream(reduce_stream)
            for t in out:
                t.record_stream(current)
        return out


def sharded_transform_step(mesh: Mesh, max_blocks: int = 2,
                           n_shards: int = 16,
                           key: bytes = b"mask-key") -> ShardedTransformStep:
    """The multi-shard transform step: rows shard over 'data', masked
    columns over 'model'; the histogram sums over every shard, the kept
    count over 'data' (see ShardedTransformStep)."""
    return ShardedTransformStep(mesh, max_blocks, n_shards, key)


def example_step_args(mesh: Mesh, rows_per_device: int = 128,
                      n_columns: Optional[int] = None,
                      max_blocks: int = 2):
    """Example host inputs of `sharded_transform_step` (the reference's
    draws, seed 0): blocks, n_blocks, ages, float64 scores."""
    data_n = mesh.shape["data"]
    model_n = mesh.shape["model"]
    n_rows = rows_per_device * data_n
    n_cols = n_columns or model_n
    rng = np.random.default_rng(0)
    blocks = rng.integers(
        0, 255, (n_cols, n_rows, max_blocks * 64), dtype=np.uint8
    )
    n_blocks = np.full((n_cols, n_rows), max_blocks, dtype=np.int32)
    ages = rng.integers(0, 99, n_rows).astype(np.int32)
    scores = rng.uniform(0, 100, n_rows)
    return blocks, n_blocks, ages, scores
