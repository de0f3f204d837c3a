"""Prometheus-shaped histogram (port of ``Histogram`` from
``omnia_tpu/utils/metrics.py``).

Only the histogram the flight recorder keeps is here: the registry and
the live collector stay with the runtime, whose ``bind_engine_metrics``
registers any object with ``name`` and ``expose()``, so this class
exposes a port engine's histograms on its ``/metrics`` as it does the
JAX engine's.
"""

from __future__ import annotations

import threading
from typing import Sequence

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return sum(self._counts)

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts (upper bound)."""
        total = self.count
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self._counts[i]
            if cum >= target:
                return b
        return float("inf")

    def expose(self) -> list[str]:
        lines = [f"# TYPE {self.name} histogram"]
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self._counts[i]
            lines.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
        cum += self._counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {self._sum}")
        lines.append(f"{self.name}_count {cum}")
        return lines
