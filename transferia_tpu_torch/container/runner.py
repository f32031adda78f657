"""Container job launcher: run connector/tool images, stream their stdout
(the port's copy of ``transferia_tpu/container/runner.py``): the
launcher behind the Airbyte provider and the dbt transformer.  Runtimes:

  docker | podman — `<rt> run --rm` with env/mount/network mapping
  exec            — run argv directly on the host (bare-metal connectors
                    and the test harness; the reference's k8s-pod mode is
                    a deployment concern handled by the pod spec there)

Runtime resolution: explicit > $TRANSFERIA_CONTAINER_RUNTIME > first of
docker/podman on PATH.  Streaming is line-oriented (Airbyte's message
protocol and dbt's log output are both line-framed JSON/text).
"""

from __future__ import annotations

import logging
import os
import selectors
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from transferia_tpu_torch.abstract.errors import CategorizedError

logger = logging.getLogger(__name__)


class ContainerError(CategorizedError):
    def __init__(self, message: str):
        super().__init__(CategorizedError.INTERNAL, message)


@dataclass
class ContainerSpec:
    image: str = ""
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    mounts: list[tuple[str, str]] = field(default_factory=list)  # host, ctr
    entrypoint: str = ""
    network: str = ""            # e.g. "host" for local endpoints
    workdir: str = ""


class ContainerRunner:
    # the longest a run may go without writing a stdout line
    IDLE_TIMEOUT = 3600.0

    def __init__(self, runtime: str = ""):
        self.runtime = runtime or os.environ.get(
            "TRANSFERIA_CONTAINER_RUNTIME", "") or self._detect()

    @staticmethod
    def _detect() -> str:
        for rt in ("docker", "podman"):
            if shutil.which(rt):
                return rt
        return ""

    def available(self) -> bool:
        return bool(self.runtime)

    def require(self) -> None:
        if not self.available():
            raise ContainerError(
                "no container runtime found (docker/podman) and "
                "TRANSFERIA_CONTAINER_RUNTIME is unset — install one on "
                "the worker or use runtime 'exec' for host binaries"
            )

    def argv(self, spec: ContainerSpec) -> list[str]:
        if self.runtime == "exec":
            # host execution: image is ignored; mounts are identity
            return list(spec.args)
        out = [self.runtime, "run", "--rm", "-i"]
        for k, v in spec.env.items():
            out += ["-e", f"{k}={v}"]
        for host, ctr in spec.mounts:
            out += ["-v", f"{host}:{ctr}"]
        if spec.network:
            out += [f"--network={spec.network}"]
        if spec.workdir:
            out += ["-w", spec.workdir]
        if spec.entrypoint:
            out += ["--entrypoint", spec.entrypoint]
        out.append(spec.image)
        out += spec.args
        return out

    def stream(self, spec: ContainerSpec,
               timeout: Optional[float] = None,
               on_stderr: Optional[Callable[[str], None]] = None
               ) -> Iterator[str]:
        """Run and yield stdout lines; raises ContainerError on a nonzero
        exit (after the stream is drained), when the run outlasts
        `timeout` seconds, or when the child writes no stdout for
        IDLE_TIMEOUT seconds (the child is killed)."""
        self.require()
        argv = self.argv(spec)
        logger.info("container run: %s", " ".join(argv[:6]))
        env = None
        if self.runtime == "exec" and spec.env:
            env = {**os.environ, **spec.env}
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env,
            cwd=spec.workdir or None if self.runtime == "exec" else None,
        )
        deadline = None if timeout is None else time.monotonic() + timeout
        # drain stderr concurrently: a child filling the stderr pipe past
        # its buffer while we block on stdout would deadlock both sides
        err_tail: list[str] = []

        def _drain_stderr():
            assert proc.stderr is not None
            for ln in proc.stderr:
                ln = ln.rstrip("\n")
                err_tail.append(ln)
                if len(err_tail) > 200:
                    del err_tail[0]
                if on_stderr:
                    on_stderr(ln)

        err_thread = threading.Thread(target=_drain_stderr, daemon=True)
        err_thread.start()
        try:
            assert proc.stdout is not None
            yield from self._lines(proc.stdout.fileno(), deadline)
            proc.wait(timeout=self._wait_s(deadline))
            err_thread.join(timeout=5)
            if proc.returncode != 0:
                raise ContainerError(
                    f"container exited rc={proc.returncode}: "
                    f"{' | '.join(err_tail[-10:])[-800:]}"
                )
        except subprocess.TimeoutExpired as e:
            raise ContainerError(
                f"container did not exit within {e.timeout:.1f}s") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def _wait_s(self, deadline: Optional[float]) -> float:
        if deadline is None:
            return self.IDLE_TIMEOUT
        return min(self.IDLE_TIMEOUT, deadline - time.monotonic())

    def _lines(self, fd: int, deadline: Optional[float]) -> Iterator[str]:
        """The pipe's lines ("\\n" or "\\r\\n" ended), each read waiting
        at most the run's time left and IDLE_TIMEOUT."""
        sel = selectors.DefaultSelector()
        sel.register(fd, selectors.EVENT_READ)
        buf = b""
        try:
            while True:
                wait = self._wait_s(deadline)
                if wait <= 0 or not sel.select(wait):
                    raise ContainerError(
                        f"container wrote no output line within "
                        f"{max(wait, 0.0):.1f}s")
                chunk = os.read(fd, 1 << 16)
                if not chunk:
                    break
                buf += chunk
                if b"\n" not in chunk:
                    continue
                lines = buf.split(b"\n")
                buf = lines.pop()
                for ln in lines:
                    yield ln.rstrip(b"\r").decode("utf-8", "replace")
            if buf:
                yield buf.rstrip(b"\r").decode("utf-8", "replace")
        finally:
            sel.close()

    def run(self, spec: ContainerSpec,
            timeout: Optional[float] = None) -> str:
        """Run to completion; returns stdout (raises on nonzero exit)."""
        return "\n".join(self.stream(spec, timeout=timeout))
