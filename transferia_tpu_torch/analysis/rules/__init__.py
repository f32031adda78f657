"""Built-in rule set for the port's `trtpu check`."""

from __future__ import annotations

from transferia_tpu_torch.analysis.engine import Rule
from transferia_tpu_torch.analysis.rules.device_purity import DevicePurityRule
from transferia_tpu_torch.analysis.rules.exception_hygiene import (
    ExceptionHygieneRule,
)
from transferia_tpu_torch.analysis.rules.failpoint_contract import (
    FailpointContractRule,
)
from transferia_tpu_torch.analysis.rules.knob_registry import (
    KnobRegistryRule,
)
from transferia_tpu_torch.analysis.rules.lock_discipline import (
    LockDisciplineRule,
)
from transferia_tpu_torch.analysis.rules.lock_order import LockOrderRule
from transferia_tpu_torch.analysis.rules.registry_contract import (
    RegistryContractRule,
)
from transferia_tpu_torch.analysis.rules.resource_safety import (
    ResourceSafetyRule,
)
from transferia_tpu_torch.analysis.rules.thread_lifecycle import (
    ThreadLifecycleRule,
)
from transferia_tpu_torch.analysis.rules.trace_contract import (
    TraceContractRule,
)

ALL_RULE_CLASSES: tuple[type, ...] = (
    DevicePurityRule,
    LockDisciplineRule,
    LockOrderRule,
    ThreadLifecycleRule,
    ExceptionHygieneRule,
    ResourceSafetyRule,
    RegistryContractRule,
    FailpointContractRule,
    TraceContractRule,
    KnobRegistryRule,
)


def default_rules() -> list[Rule]:
    return [cls() for cls in ALL_RULE_CLASSES]


__all__ = [
    "ALL_RULE_CLASSES",
    "default_rules",
    "DevicePurityRule",
    "KnobRegistryRule",
    "LockDisciplineRule",
    "LockOrderRule",
    "ThreadLifecycleRule",
    "ExceptionHygieneRule",
    "FailpointContractRule",
    "ResourceSafetyRule",
    "RegistryContractRule",
    "TraceContractRule",
]
