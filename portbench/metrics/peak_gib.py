"""peak_gib (GiB): torch.cuda.max_memory_allocated over the window, its
peak reset after the warm-up proof."""


def read(run):
    return run.peak_bytes / 2**30
