"""Set-up seconds (host clock): process start to the first timed prove.
Imports, the kernel and C builds or their loads, the Dory SRS, the device
row engine, the guests and one warm-up prove."""


def read(run):
    return run.setup_s
