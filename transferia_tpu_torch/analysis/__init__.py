"""Framework-aware static analysis (`trtpu check`) of the port's tree
(the port's copy of ``transferia_tpu/analysis/``).

An AST-based lint engine purpose-built for this codebase's hazard
classes: host syncs in kernel-launch code (TPU001), lock discipline in
threaded modules (LCK001) and lock-order cycles (LCK002), thread and
timer lifecycle (THD001), exception hygiene (EXC001), socket/file
resource safety (NET001), the plugin-registry contract (REG001), the
failpoint-site and trace contracts (FPT001, TRC001) and env-knob drift
(KNB001).  It reads source files only: no device, no compile.
"""

from transferia_tpu_torch.analysis.engine import (
    CheckResult,
    Finding,
    ProjectRule,
    Rule,
    Suppressions,
    run_rules,
)
from transferia_tpu_torch.analysis.rules import ALL_RULE_CLASSES, default_rules

__all__ = [
    "CheckResult",
    "Finding",
    "ProjectRule",
    "Rule",
    "Suppressions",
    "run_rules",
    "ALL_RULE_CLASSES",
    "default_rules",
]
