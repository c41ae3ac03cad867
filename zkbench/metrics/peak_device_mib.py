"""Peak device memory of the run, torch.cuda.max_memory_allocated, in MiB."""


def read(run):
    return run.peak_bytes / 2 ** 20
