"""Elastic autoscaler: turn the fleet's `desired_workers` hint into
actual worker processes, with hysteresis (the port's copy of
``transferia_tpu/fleet/autoscaler.py``).

The scheduler computes `desired_workers` as a gauge; this loop
consumes it: each step it reads the
durable queue's pending depth through the scheduler
(fleet/distributed.py `desired_workers()`, recomputed from the queue on
every read), clamps to [min_workers, max_workers], and drives the
`WorkerSupervisor` (fleet/worker.py) toward the target —

- **scale-up** only after the desire has been SUSTAINED for
  `scale_up_after` consecutive steps (a one-tick burst of admissions
  must not fork a worker that will be idle before it finishes
  importing), and then all the way to the sustained target;
- **scale-down** only after `scale_down_after` consecutive low steps,
  and then by ONE worker per step, by draining an IDLE worker
  (SIGTERM → part-boundary yield → release → exit) — a busy fleet is
  never shrunk by killing work, and the gradual drain keeps a noisy
  queue depth from sawtoothing the pool;
- crashed workers are reaped each step and re-spawned by the same
  scale_to call that enforces the floor, so `min_workers` is also the
  crash-replacement guarantee.

Each step also runs the scheduler's `tick()` (gauge refresh + one
preemption decision), so the INTERACTIVE-preempts-SCAVENGER rule fires
on the same cadence as scaling.  `step()` is synchronous and
side-effect-complete — the unit tests drive it directly; `start()`
wraps it in the background loop the CLI uses.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from transferia_tpu_torch.fleet.distributed import DistributedFleetScheduler
from transferia_tpu_torch.fleet.worker import WorkerSupervisor
from transferia_tpu_torch.stats import trace

logger = logging.getLogger(__name__)


class FleetAutoscaler:
    def __init__(self, scheduler: DistributedFleetScheduler,
                 supervisor: WorkerSupervisor,
                 min_workers: int = 1, max_workers: int = 8,
                 scale_up_after: int = 2, scale_down_after: int = 5,
                 interval: float = 1.0, name: str = "fleet-scaler",
                 leader: "Optional[object]" = None):
        if min_workers < 0 or max_workers < max(1, min_workers):
            raise ValueError("need 0 <= min_workers <= max_workers "
                             "and max_workers >= 1")
        self.scheduler = scheduler
        self.supervisor = supervisor
        # scheduler-replica leader election (fleet/leader.py): with a
        # LeaderLease only ONE replica runs the preemption/autoscale
        # tick per period; standby replicas keep reaping their own
        # local workers (a crashed subprocess is this replica's to
        # collect regardless of who leads) and take over automatically
        # when the leader's lease expires
        self.leader = leader
        # close the preemption loop: without a capacity probe the
        # scheduler skips its free-lane check and would revoke running
        # work even while an idle worker could absorb the arrival
        # within one claim poll — the supervisor IS the probe
        if getattr(scheduler, "_capacity", None) is None and \
                hasattr(supervisor, "live_workers"):
            scheduler._capacity = supervisor.live_workers
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.scale_up_after = max(1, scale_up_after)
        self.scale_down_after = max(1, scale_down_after)
        self.interval = interval
        self.name = name
        self._up_streak = 0
        self._down_streak = 0
        self._steps = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._last_action = "none"
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def target(self) -> int:
        """The clamped desire, recomputed from the durable queue."""
        return min(self.max_workers,
                   max(self.min_workers,
                       self.scheduler.desired_workers()))

    def step(self) -> dict:
        """One synchronous control step (reap → tick → hysteresis →
        scale).  Returns the decision record `snapshot()` also shows.
        With a leader lease configured, a standby replica only reaps —
        it neither ticks the scheduler nor scales."""
        self._steps += 1
        self.supervisor.reap()
        if self.leader is not None and not self.leader.ensure():
            self._up_streak = self._down_streak = 0
            self._last_action = "standby"
            self.scheduler.stats.live_workers.set(
                self.supervisor.live_workers())
            return {"desired": None,
                    "live": self.supervisor.live_workers(),
                    "action": "standby"}
        self.scheduler.tick()
        desired = self.target()
        live = self.supervisor.live_workers()
        action = "hold"
        if live < self.min_workers:
            # floor enforcement / crash replacement bypasses hysteresis:
            # a fleet below its floor is not a trend, it is an outage
            self.supervisor.scale_to(self.min_workers)
            self._up_streak = self._down_streak = 0
            self._scale_ups += 1
            self.scheduler.stats.autoscale_ups.inc()
            action = f"floor:{self.min_workers}"
        elif desired > live:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= self.scale_up_after:
                self.supervisor.scale_to(desired)
                self._up_streak = 0
                self._scale_ups += 1
                self.scheduler.stats.autoscale_ups.inc()
                action = f"up:{desired}"
        elif desired < live:
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= self.scale_down_after:
                retired = self.supervisor.retire_one()
                self._down_streak = 0
                if retired is not None:
                    self._scale_downs += 1
                    self.scheduler.stats.autoscale_downs.inc()
                    action = f"down:w{retired}"
        else:
            self._up_streak = self._down_streak = 0
        self._last_action = action
        if action != "hold":
            trace.instant("fleet_autoscale", action=action,
                          desired=desired, live=live)
            logger.info("%s step %d: desired=%d live=%d -> %s",
                        self.name, self._steps, desired, live, action)
        self.scheduler.stats.live_workers.set(
            self.supervisor.live_workers())
        return {"desired": desired, "live": live, "action": action}

    # -- background loop -----------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            return self
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.register_autoscaler(self)
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.step()
                except Exception:
                    logger.exception("%s step failed", self.name)

        self._thread = threading.Thread(target=loop, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.leader is not None:
            # graceful step-down: a standby replica takes over on its
            # next tick instead of waiting out the lease TTL
            self.leader.release()
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.unregister_autoscaler(self)

    def snapshot(self) -> dict:
        """/debug/fleet payload: the scaling policy's live state."""
        if self.leader is not None:
            leader = {"is_leader": self.leader.is_leader(),
                      "replica_id": self.leader.replica_id}
        else:
            leader = None
        return {
            "name": self.name,
            "leader": leader,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "desired": self.target(),
            "live": self.supervisor.live_workers(),
            "draining": self.supervisor.draining_workers(),
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "scale_up_after": self.scale_up_after,
            "scale_down_after": self.scale_down_after,
            "steps": self._steps,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "last_action": self._last_action,
        }
