"""Launches of the program's own kernels (the __global__ functions of its
csrc/), counted in the profiler's trace of the window, a mean over its
proves."""

from zkbench import trace


def read(run):
    if run.trace is None or not run.trace.proves:
        return None
    return len(trace.kernel_events(run.trace, run.kernels)) / run.trace.proves
