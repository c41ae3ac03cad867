"""Commitments: the program's `commitments` span (zkvm/commitments, kernel B
in msm/rows_device, pcs/dory, native/), a mean over the window's proves."""

NAMES = ("commitments",)


def read(run):
    """Mean seconds a completed prove of the window spent in the spans."""
    return run.mean_span_s(NAMES)
