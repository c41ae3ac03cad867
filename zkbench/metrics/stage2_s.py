"""Stage 2: the program's `stage2` span (zkvm/stage2_batch), a mean over the
window's proves."""

NAMES = ("stage2",)


def read(run):
    """Mean seconds a completed prove of the window spent in the spans."""
    return run.mean_span_s(NAMES)
