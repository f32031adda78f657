"""Deterministic fault injection (the port's copy of the JAX package's
`failpoints` and its site catalog `sites`).

Production call sites import only `failpoints`: named injection sites
compiled into the hot path at zero cost when disabled, armed by a seeded
spec through `configure` or `TRANSFERIA_TPU_FAILPOINTS`.  A spec and a
seed fire on the same hits as in the JAX package.
"""

from transferia_tpu_torch.chaos import failpoints
from transferia_tpu_torch.chaos.sites import SITES, site_names

__all__ = ["failpoints", "SITES", "site_names"]
