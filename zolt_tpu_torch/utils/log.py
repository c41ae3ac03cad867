"""Structured observability: grep-able log tags + a per-stage metrics registry.

The reference's verification method is differential logging: every prover
stage prints stable machine-parseable tags (`[ZOLT] STAGE1_ROUND_n: c0 = ...`,
reference src/zkvm/proof_converter.zig:502-534) that scripts diff against an
instrumented Jolt build. This module formalizes the same idea for the TPU
build (SURVEY §5.5): stable `[ZTPU] TAG: ...` lines, gated by the
ZOLT_TPU_LOG environment variable (0/off by default so proving stays quiet),
plus a process-wide metrics registry that accumulates per-stage wall times and
element counts for `prove --timings` and the bench harness.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager


def log_enabled() -> bool:
    return os.environ.get("ZOLT_TPU_LOG", "0") not in ("", "0", "false")


def zlog(tag: str, msg: str) -> None:
    """Emit one structured `[ZTPU] TAG: msg` line (stderr) when enabled."""
    if log_enabled():
        print(f"[ZTPU] {tag}: {msg}", file=sys.stderr, flush=True)


class Metrics:
    """Accumulates named timings/counters; one instance per process.

    Usage:  with metrics.stage("stage2"): ...   then metrics.timings -> dict.
    """

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            zlog("TIMING", f"{name} = {dt * 1e3:.2f} ms")

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def reset(self) -> None:
        self.timings.clear()
        self.counters.clear()

    def report_lines(self) -> list[str]:
        out = [f"  {k:<28} {v * 1e3:>10.2f} ms" for k, v in self.timings.items()]
        out += [f"  {k:<28} {v:>10}" for k, v in self.counters.items()]
        return out


metrics = Metrics()
