"""peak_hbm_gib (GiB): torch.cuda.max_memory_allocated() over the window,
reset at its start; the resident inputs and tables included."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
