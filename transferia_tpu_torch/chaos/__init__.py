"""Deterministic fault injection and delivery-invariant verification
(the port's copy of the JAX package's `chaos/`).

Three planes (keep imports light — production call sites import only
`failpoints`):

- `failpoints` — named injection sites compiled into the hot path at
  zero cost when disabled, armed by a seeded spec through `configure`
  or `TRANSFERIA_TPU_FAILPOINTS`; a spec and a seed fire on the same
  hits as in the JAX package (site catalog: `sites`, enforced by the
  lint's FPT001);
- `invariants` — the delivery auditor: at-least-once, bounded
  duplication, checkpoint monotonicity, epoch fencing, exactly-once and
  post-retry fingerprint equality, over K10's row keys on the caller's
  device;
- `runner` — `trtpu chaos`: seeded fault schedules over the built-in
  transfers on one device, replayable with --seed (`wire_backends`: the
  exactly-once backends over the port's protocol fakes).
"""

from transferia_tpu_torch.chaos import failpoints
from transferia_tpu_torch.chaos.sites import SITES, site_names

__all__ = ["failpoints", "SITES", "site_names"]
