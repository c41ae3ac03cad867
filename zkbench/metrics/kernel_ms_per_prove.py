"""Device milliseconds of the program's own kernels in the profiler's trace
of the window, a mean over its proves. Nothing where none ran."""

from zkbench import trace


def read(run):
    if run.trace is None or not run.trace.proves:
        return None
    ev = trace.kernel_events(run.trace, run.kernels)
    if not ev:
        return None
    return sum(b - a for _, a, b in ev) * 1e3 / run.trace.proves
