"""Witness generation: the program's `witness_gen` span (vm/, r1cs/inputs,
parallel/device_cols), a mean over the window's proves."""

NAMES = ("witness_gen",)


def read(run):
    """Mean seconds a completed prove of the window spent in the spans."""
    return run.mean_span_s(NAMES)
