"""dbt transformation: run a dbt project against the TARGET after load
(the port's copy of ``transferia_tpu/transform/plugins/dbt.py``).

dbt is configured as a transformer but does not touch row batches; the
main worker runs the dbt container against the destination once the
snapshot has landed.  run_dbt_transformations() is invoked by the
activation task after upload.

The container mounts the project directory and a generated profiles.yml
for the destination (ClickHouse/Postgres adapters); runtime "exec" runs a
host dbt binary instead (also how tests exercise the full flow without
docker).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.container import ContainerRunner, ContainerSpec
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer

logger = logging.getLogger(__name__)


class DbtError(CategorizedError):
    def __init__(self, message: str):
        super().__init__(CategorizedError.TARGET, message)


@register_transformer("dbt")
class DbtTransformer(Transformer):
    """Config carrier: never joins row plans (suitable() is False); the
    activation task collects these and calls run()."""

    TYPE = "dbt"

    def __init__(self, project_path: str = "", operation: str = "run",
                 profile_name: str = "transferia",
                 image: str = "ghcr.io/dbt-labs/dbt-clickhouse:1.8.0",
                 runtime: str = "", exec_argv: Optional[list] = None,
                 **_):
        self.project_path = project_path
        self.operation = operation
        self.profile_name = profile_name
        self.image = image
        self.runtime = runtime
        self.exec_argv = exec_argv or []

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return False  # not a row transformer (reference: sink-close hook)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        return TransformResult(batch)  # pragma: no cover - never planned

    def describe(self) -> str:
        return f"dbt({self.operation})"

    # -- execution ----------------------------------------------------------
    def _profiles_yaml(self, dst) -> str:
        """Generate profiles.yml for the destination endpoint params."""
        provider = getattr(dst, "PROVIDER", "")
        if provider == "ch":
            out = {
                "type": "clickhouse",
                "host": getattr(dst, "host", "localhost"),
                "port": getattr(dst, "port", 8123),
                "user": getattr(dst, "user", "default"),
                "password": getattr(dst, "password", ""),
                "schema": getattr(dst, "database", "default"),
            }
        elif provider == "pg":
            out = {
                "type": "postgres",
                "host": getattr(dst, "host", "localhost"),
                "port": getattr(dst, "port", 5432),
                "user": getattr(dst, "user", ""),
                "password": getattr(dst, "password", ""),
                "dbname": getattr(dst, "database", ""),
                "schema": "public",
            }
        else:
            raise DbtError(
                f"dbt transformation does not support destination "
                f"{provider!r} (clickhouse/postgres)"
            )
        import json as _json

        lines = [f"{self.profile_name}:", "  target: t", "  outputs:",
                 "    t:"]
        for k, v in out.items():
            # JSON scalar quoting is valid YAML (repr() is not: its
            # backslash escapes corrupt passwords with quotes/backslashes)
            lines.append(f"      {k}: {_json.dumps(v)}")
        return "\n".join(lines) + "\n"

    def run(self, dst) -> None:
        import shutil

        runner = ContainerRunner(self.runtime)
        profiles_dir = tempfile.mkdtemp(prefix="dbt_profiles_")
        try:
            with open(os.path.join(profiles_dir, "profiles.yml"),
                      "w") as fh:
                fh.write(self._profiles_yaml(dst))
            if runner.runtime == "exec":
                spec = ContainerSpec(
                    args=list(self.exec_argv) + [
                        self.operation, "--profiles-dir", profiles_dir,
                        "--project-dir", self.project_path,
                        "--profile", self.profile_name,
                    ],
                )
            else:
                spec = ContainerSpec(
                    image=self.image,
                    args=[self.operation,
                          "--profiles-dir", "/dbt_profiles",
                          "--project-dir", "/dbt_project",
                          "--profile", self.profile_name],
                    mounts=[(self.project_path, "/dbt_project"),
                            (profiles_dir, "/dbt_profiles")],
                    network="host",
                )
            for line in runner.stream(spec):
                logger.info("dbt: %s", line)
        finally:
            # profiles.yml holds the destination password — never leave
            # it behind in /tmp
            shutil.rmtree(profiles_dir, ignore_errors=True)


def run_dbt_transformations(transfer, coordinator=None) -> int:
    """Run every configured dbt step against the destination (main-worker
    post-upload hook; no-op without dbt config).  Returns steps run."""
    cfg = getattr(transfer, "transformation", None)
    if not cfg:
        return 0
    steps = [t for t in (cfg.get("transformers") or []) if "dbt" in t]
    if not steps:
        return 0
    if getattr(transfer.runtime, "current_job", 0) != 0:
        return 0  # reference: executedByMainWorker only
    n = 0
    for t in steps:
        step = DbtTransformer(**(t["dbt"] or {}))
        logger.info("running dbt transformation: %s", step.describe())
        try:
            step.run(transfer.dst)
        except Exception as e:
            if coordinator is not None:
                coordinator.open_status_message(
                    transfer.id, "dbt", str(e))
            raise
        n += 1
    return n
