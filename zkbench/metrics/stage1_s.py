"""Stage 1: the program's `stage1` span (zkvm/streaming_outer,
zkvm/device_outer, r1cs/uniskip), a mean over the window's proves."""

NAMES = ("stage1",)


def read(run):
    """Mean seconds a completed prove of the window spent in the spans."""
    return run.mean_span_s(NAMES)
