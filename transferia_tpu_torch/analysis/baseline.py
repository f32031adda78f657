"""Committed-baseline support for `trtpu check`.

Pre-existing findings are recorded (fingerprinted) in a JSON file so
`--strict` only fails on NEW findings — the same ratchet pattern as
mypy/ruff baselines.  Fingerprints hash (path, rule, source-line text,
occurrence index) rather than line numbers, so a finding stays matched
when unrelated code shifts it up or down the file.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

from transferia_tpu_torch.analysis.engine import Finding

# the port's own baseline; the JAX package keeps .trtpu-baseline.json
DEFAULT_BASELINE = ".trtpu-torch-baseline.json"
_VERSION = 1


def fingerprints(findings: Sequence[Finding]) -> list[str]:
    """Stable ids, parallel to `findings` (sorted order expected).

    The occurrence counter disambiguates identical snippets (two
    `except Exception: pass` in one file) without pinning to line
    numbers.
    """
    seen: dict[tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        key = (f.path, f.rule, f.snippet)
        n = seen.get(key, 0)
        seen[key] = n + 1
        digest = hashlib.sha1(
            f"{f.path}|{f.rule}|{f.snippet}|{n}".encode()).hexdigest()[:16]
        out.append(digest)
    return out


def load(path: str) -> set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return set(data.get("findings", {}))


def save(path: str, findings: Sequence[Finding]) -> int:
    """Write the baseline for `findings`; returns the entry count."""
    entries = {}
    for fp, f in zip(fingerprints(findings), findings):
        entries[fp] = {"rule": f.rule, "path": f.path,
                       "message": f.message, "snippet": f.snippet}
    payload = {"version": _VERSION,
               "findings": dict(sorted(entries.items()))}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return len(entries)


def split(findings: Sequence[Finding], baseline: set[str]
          ) -> tuple[list[Finding], list[Finding]]:
    """-> (new, baselined)."""
    new, old = [], []
    for fp, f in zip(fingerprints(findings), findings):
        (old if fp in baseline else new).append(f)
    return new, old


def stale(findings: Sequence[Finding], baseline: set[str]) -> set[str]:
    """Baseline entries no longer produced (candidates for cleanup)."""
    return baseline - set(fingerprints(findings))
