"""What a torch.profiler trace of the window says, in a form the metric
readers share: the device's busy intervals by operation, the spans the
benchmark marked, and the window.

The benchmark marks each of the program's `metrics.stage` spans with a
`torch.profiler.record_function` named SPAN + the stage's name, each prove
with PROVE and the window with WINDOW, so that spans and device operations
share the profiler's clock.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

SPAN = "zkbench.span:"
PROVE = "zkbench.prove"
WINDOW = "zkbench.window"


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""
    window: tuple[float, float]
    device: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    proves: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def from_profiler(prof) -> Trace:
    """The window's trace from a finished torch.profiler.profile, read from
    its raw events (building the profiler's event tree costs minutes on a
    window of host-heavy proves). Device operations are the events the
    profiler saw on the CUDA device, less the device-side copies of the
    benchmark's own annotations."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    device, spans, window, proves = [], [], None, 0
    for e in res.events():
        name = e.name()
        on_cpu = e.device_type() == DeviceType.CPU
        if name.startswith("zkbench."):
            if not on_cpu:
                continue
            t0, t1 = e.start_ns() / 1e9, e.end_ns() / 1e9
            if name == WINDOW:
                window = (t0, t1)
            elif name == PROVE:
                proves += 1
            elif name.startswith(SPAN):
                spans.append((name[len(SPAN):], t0, t1))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, e.start_ns() / 1e9, e.end_ns() / 1e9))
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    return Trace(window=window, device=device, spans=spans, proves=proves)


def _clip(iv, window):
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def busy_intervals(tr: Trace) -> list[tuple[float, float]]:
    """The union of the device operations' intervals inside the window."""
    out = []
    for a, b in sorted(_clip([(a, b) for _, a, b in tr.device], tr.window)):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr))


def span_at(tr: Trace, t: float) -> str:
    """The innermost marked span open at time t, or 'outside_spans' (the
    guest's run and the serialization inside a prove, the harness between
    proves)."""
    best = None
    for name, a, b in tr.spans:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "outside_spans"


def idle_gaps(tr: Trace) -> list[tuple[str, float]]:
    """Every stretch of the window in which the device ran nothing, with
    the span open at its middle; longest first."""
    gaps, t = [], tr.window[0]
    for a, b in busy_intervals(tr) + [(tr.window[1], tr.window[1])]:
        if a > t:
            gaps.append((span_at(tr, (t + a) / 2), a - t))
        t = max(t, b)
    return sorted(gaps, key=lambda g: -g[1])


def device_ops(tr: Trace) -> list[tuple[str, float]]:
    """Device seconds by operation name inside the window, most first."""
    tot = {}
    for name, a, b in tr.device:
        for x, y in _clip([(a, b)], tr.window):
            tot[name] = tot.get(name, 0.0) + (y - x)
    return sorted(tot.items(), key=lambda kv: -kv[1])


# -- the program's own kernels --------------------------------------------------

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def kernel_names(csrc_dir: str) -> set[str]:
    """The names of the __global__ functions in the program's CUDA sources."""
    names = set()
    for f in sorted(os.listdir(csrc_dir)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, f)) as fh:
                names.update(_GLOBAL.findall(fh.read()))
    return names


def kernel_of(op_name: str, names) -> str | None:
    """Which of `names` a profiler operation's (demangled) name launches."""
    for n in names:
        if re.search(rf"(^|[^\w]){re.escape(n)}(\s*[<(]|$)", op_name):
            return n
    return None


def kernel_events(tr: Trace, names) -> list[tuple[str, float, float]]:
    """The window's device operations that are launches of `names`."""
    out = []
    for op, a, b in tr.device:
        k = kernel_of(op, names)
        if k is not None and tr.window[0] <= a < tr.window[1]:
            out.append((k, a, b))
    return out
