"""Proved cycles per second: the padded trace cycles of every prove that
completed correctly in the window, over the window's span (host clock, from
the start of the first timed prove to the end of the first prove that ended
after --seconds)."""


def read(run):
    return run.cycles_correct / run.window_s
