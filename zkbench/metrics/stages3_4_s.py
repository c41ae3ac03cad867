"""Stages 3-4: the program's `stage3` and `stage4` spans (zkvm/stage3,
zkvm/stage4), a mean over the window's proves."""

NAMES = ("stage3", "stage4")


def read(run):
    """Mean seconds a completed prove of the window spent in the spans."""
    return run.mean_span_s(NAMES)
