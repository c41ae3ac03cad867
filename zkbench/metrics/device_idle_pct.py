"""The device's idle share: the traced window less the union of the
intervals in which any operation ran on the device, over the window."""

from zkbench import trace


def read(run):
    if run.trace is None:
        return None
    w = run.trace.window_s
    return (w - trace.busy_s(run.trace)) / w * 100
