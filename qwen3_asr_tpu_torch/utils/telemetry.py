"""Serving metrics in the Prometheus text format, for ``GET /metrics``.

Counterpart of ``qwen3_asr_tpu/utils/telemetry.py``: counters, latency
histograms on the same buckets, gauges, one ``# TYPE`` line a metric name
and ``asr_uptime_seconds``. The server's manager owns one registry
(``ModelManager.metrics``), as the JAX package's process does.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._hist: Dict[Tuple[str, Tuple], List[int]] = {}
        self._hist_sum: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self.started_at = time.time()

    def inc(self, name: str, value: float = 1.0, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] += value

    def observe(self, name: str, seconds: float, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            buckets = self._hist.setdefault(key, [0] * (len(_BUCKETS) + 1))
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._hist_sum[key] += seconds

    def gauge(self, name: str, value: float, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value

    @staticmethod
    def _fmt_labels(labels: Tuple) -> str:
        if not labels:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"

    def render(self) -> str:
        """The registry in the Prometheus text format, one ``# TYPE`` line
        a metric name (strict parsers refuse a repeated one)."""
        lines = []
        typed = set()

        def type_line(name: str, kind: str):
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        def bucket_labels(labels: Tuple, le) -> str:
            return self._fmt_labels(tuple(sorted({**dict(labels),
                                                  "le": le}.items())))

        with self._lock:
            for (name, labels), value in sorted(self._counters.items()):
                type_line(name, "counter")
                lines.append(f"{name}{self._fmt_labels(labels)} {value}")
            for (name, labels), buckets in sorted(self._hist.items()):
                type_line(name, "histogram")
                cumulative = 0
                for i, b in enumerate(_BUCKETS):
                    cumulative += buckets[i]
                    lines.append(f"{name}_bucket{bucket_labels(labels, b)}"
                                 f" {cumulative}")
                cumulative += buckets[-1]
                lines.append(f"{name}_bucket{bucket_labels(labels, '+Inf')}"
                             f" {cumulative}")
                lines.append(f"{name}_count{self._fmt_labels(labels)} "
                             f"{cumulative}")
                lines.append(f"{name}_sum{self._fmt_labels(labels)} "
                             f"{round(self._hist_sum[(name, labels)], 4)}")
            for (name, labels), value in sorted(self._gauges.items()):
                type_line(name, "gauge")
                lines.append(f"{name}{self._fmt_labels(labels)} {value}")
        lines.append("# TYPE asr_uptime_seconds gauge")
        lines.append(
            f"asr_uptime_seconds {round(time.time() - self.started_at, 1)}")
        return "\n".join(lines) + "\n"
