"""Profiling/observability helpers — the aux subsystem analog of the
reference's VCD dumps and cycle counters (SURVEY.md section 5:
dump.v $dumpvars, IN/OUT/CYCLES/WAIT prints at test_deflate.py:191-192).

On the device the equivalents are jax.profiler traces and per-stage GB/s
counters.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@dataclass
class Counter:
    """Throughput counter for one stage."""

    name: str
    bytes_processed: int = 0
    seconds: float = 0.0
    calls: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_processed / self.seconds / 1e9 if self.seconds else 0.0

    def as_dict(self):
        return {
            "name": self.name,
            "bytes": self.bytes_processed,
            "seconds": round(self.seconds, 6),
            "calls": self.calls,
            "GB/s": round(self.gbps, 4),
        }


@dataclass
class Profiler:
    """Lightweight stage profiler.

    with prof.stage("encode", nbytes=len(data)):
        ...  # timed with block_until_ready semantics left to the caller
    """

    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        c = self.counters.setdefault(name, Counter(name))
        t0 = time.perf_counter()
        try:
            yield c
        finally:
            c.seconds += time.perf_counter() - t0
            c.bytes_processed += nbytes
            c.calls += 1

    def report(self) -> str:
        return json.dumps([c.as_dict() for c in self.counters.values()])


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view in XProf/TensorBoard) — the VCD
    waveform dump analog."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
