"""Sink factory: assembles the full middleware pipeline (the port's copy
of ``transferia_tpu/factories/sink.py``).

Sync middleware order, innermost first: TargetFallbacks,
SourceFallbacks, OutputMetering, Statistician, Filter(system tables),
NonRowSeparator, [post-transform wrap], Transformation, InputMetering,
Measurer, [Retrier @snapshot]; the async wrap is
ErrorTracker(MemThrottler(Bufferer|Synchronizer(sync stack))).

Push flow (outermost -> innermost):

  async_push -> ErrorTracker -> [MemThrottler] -> Bufferer/Synchronizer
    -> [Retrier @snapshot] -> Measurer -> Transformation -> NonRowSeparator
    -> Filter -> Statistician -> SourceFallbacks -> TargetFallbacks -> sink

The Bufferer sits at the async/sync boundary so the chain's kernels see
large merged batches.  `device` is where the pipeline's device work
runs: the chain's fused steps, the post-transform wrap the caller builds
on it (the snapshot loader's fingerprint tap) and the memory sink's
staged-row keys.  None means CUDA, which must be present; "cpu" runs the
kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.interfaces import AsyncSink, Sinker
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.metering.agent import (
    InputMetering,
    OutputMetering,
    metering_agent,
)
from transferia_tpu_torch.middlewares.asynchronizer import (
    Bufferer,
    BuffererConfig,
    ErrorTracker,
    MemThrottler,
    Synchronizer,
)
from transferia_tpu_torch.middlewares.sync import (
    Filter,
    Measurer,
    NonRowSeparator,
    Retrier,
    Statistician,
    Transformation as TransformationMW,
    TypeFallbacks,
)
from transferia_tpu_torch.models.endpoint import capability
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats.registry import Metrics, SinkerStats
from transferia_tpu_torch.transform.chain import build_chain
from transferia_tpu_torch.typesystem.fallbacks import fallbacks_for

SYSTEM_TABLE_PREFIX = "__"  # system tables excluded from delivery


def _system_table_filter(tid: TableID) -> bool:
    return tid.name.startswith(SYSTEM_TABLE_PREFIX) and \
        tid.name not in ("__test",)


def make_sinker(transfer, metrics: Optional[Metrics] = None,
                snapshot_stage: bool = False,
                stats: Optional[SinkerStats] = None,
                post_transform_wrap=None,
                device: DeviceLike = None) -> Sinker:
    """Build the synchronous middleware stack over the provider's raw
    sink."""
    device = resolve_device(device)
    metrics = metrics or Metrics()
    provider = get_provider(transfer.dst_provider(), transfer, metrics,
                            device=device)
    raw: Optional[Sinker] = None
    if snapshot_stage:
        raw = provider.snapshot_sinker()
    if raw is None:
        raw = provider.sinker()
    if raw is None:
        raise ValueError(
            f"provider {transfer.dst_provider()!r} has no sink capability"
        )
    version = transfer.type_system_version
    s: Sinker = raw
    tgt_fb = fallbacks_for(transfer.dst_provider(), "target", version)
    if tgt_fb:
        s = TypeFallbacks(s, tgt_fb)
    src_fb = fallbacks_for(transfer.src_provider(), "source", version)
    if src_fb:
        s = TypeFallbacks(s, src_fb)
    agent = metering_agent(transfer.id)
    s = OutputMetering(s, agent)
    s = Statistician(s, stats or SinkerStats(metrics),
                     transfer_id=transfer.id)
    s = Filter(s, _system_table_filter)
    s = NonRowSeparator(s)
    if post_transform_wrap is not None:
        # observers of post-transform data (the snapshot loader's inline
        # fingerprint tap)
        s = post_transform_wrap(s)
    chain = build_chain(transfer.transformation, device=device)
    if chain is not None:
        s = TransformationMW(s, chain)
    s = InputMetering(s, agent)
    s = Measurer(s)
    if snapshot_stage:
        s = Retrier(s)
    return s


def make_async_sink(transfer, metrics: Optional[Metrics] = None,
                    snapshot_stage: bool = False,
                    stats: Optional[SinkerStats] = None,
                    post_transform_wrap=None,
                    device: DeviceLike = None) -> AsyncSink:
    """The full async pipeline.  A provider's native AsyncSink has no
    sync stack to host post_transform_wrap; otherwise the sync stack is
    wrapped with a Bufferer (when the destination opts in through
    `bufferer_config`) or a Synchronizer."""
    device = resolve_device(device)
    metrics = metrics or Metrics()
    provider = get_provider(transfer.dst_provider(), transfer, metrics,
                            device=device)
    native = provider.async_sink()
    if native is not None:
        return ErrorTracker(native)
    sync_stack = make_sinker(transfer, metrics, snapshot_stage, stats,
                             post_transform_wrap=post_transform_wrap,
                             device=device)
    buf_cfg = capability(transfer.dst, "bufferer_config", None)
    if buf_cfg is not None and not isinstance(buf_cfg, BuffererConfig):
        buf_cfg = BuffererConfig(**buf_cfg) if isinstance(buf_cfg, dict) \
            else BuffererConfig()
    a: AsyncSink
    if buf_cfg is not None:
        a = Bufferer(sync_stack, buf_cfg)
    else:
        a = Synchronizer(sync_stack)
    limit = capability(transfer.dst, "memory_limit_bytes", None)
    if limit:
        a = MemThrottler(a, limit)
    return ErrorTracker(a)
