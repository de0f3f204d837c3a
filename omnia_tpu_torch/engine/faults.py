"""Deterministic fault injection (port of ``omnia_tpu/engine/faults.py``).

A :class:`FaultPlan` is a small, counted, thread-safe script of faults
that ``InferenceEngine._fault_plan`` consults at well-defined seams, so
that a test or a smoke run can inject the faults the engine's
robustness paths guard against and count the terminals exactly.

Every fault is bounded by an explicit count, so a plan fires a known
number of times and a test can reconcile the engine's metrics against
``plan.fired`` exactly: no randomness, no wall-clock races in the
assertions.

Seams (who consults what):

- ``take_submit_fault()``: ``submit()``; the first ``flaky_submit``
  submits raise ``RuntimeError`` (a flaky worker transport; a
  coordinator's failover path).
- ``take_death()`` / ``take_export_fault()``: kept with the JAX
  package's fields and counters for a mock worker; this package's
  engine consults neither.
- ``take_hang_s()`` / ``slow_sync_s``: the host-sync seam,
  ``InferenceEngine._sync_chunk_host`` (a decode chunk's device-to-host
  read). A hang longer than the engine's ``watchdog_s`` trips the
  hung-dispatch watchdog; ``slow_sync_s`` is an uncounted per-sync tax.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


class WatchdogTimeout(RuntimeError):
    """A decode chunk's host sync exceeded EngineConfig.watchdog_s.

    Raised out of the scheduler's chunk sync; the engine loop's recovery
    path catches it, fails in-flight handles, and reallocates device
    state."""


@dataclasses.dataclass
class FaultPlan:
    """A counted, deterministic script of injectable faults.

    Counters make every fault finite: after ``die_count`` deaths /
    ``hang_count`` hangs / ``flaky_submit`` submit failures the plan is
    spent and the worker behaves normally, so a scenario has a
    deterministic shape (fault, degrade, recover) instead of a flap
    loop. ``fired`` records how many times each fault actually fired.
    """

    # Each affected request emits this many tokens, then the worker
    # dies mid-request (ERROR final). 0 = death before the first token.
    die_after_tokens: Optional[int] = None
    die_count: int = 1
    # Host-sync hang per affected dispatch (seconds); trips the
    # hung-dispatch watchdog when it exceeds the engine's watchdog_s.
    hang_dispatch_s: float = 0.0
    hang_count: int = 1
    # The first N submit() calls raise RuntimeError (flaky transport).
    flaky_submit: int = 0
    # The first N export_session() calls raise RuntimeError.
    export_faults: int = 0
    # Added to EVERY sync: an uncounted latency tax (slow link), never
    # a terminal fault by itself.
    slow_sync_s: float = 0.0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self.fired: dict[str, int] = {
            "deaths": 0, "submit_faults": 0, "hangs": 0, "export_faults": 0,
        }

    # -- consumption seams (each decides-and-counts atomically) --------

    def take_submit_fault(self) -> bool:
        with self._lock:
            if self.fired["submit_faults"] < self.flaky_submit:
                self.fired["submit_faults"] += 1
                return True
        return False

    def take_export_fault(self) -> bool:
        with self._lock:
            if self.fired["export_faults"] < self.export_faults:
                self.fired["export_faults"] += 1
                return True
        return False

    def take_death(self) -> bool:
        with self._lock:
            if self.die_after_tokens is not None and self.fired["deaths"] < self.die_count:
                self.fired["deaths"] += 1
                return True
        return False

    def take_hang_s(self) -> float:
        with self._lock:
            if self.hang_dispatch_s > 0.0 and self.fired["hangs"] < self.hang_count:
                self.fired["hangs"] += 1
                return self.hang_dispatch_s
        return 0.0
