"""setup_s (s, host clock): process start to the window: inputs made on the
card, the entry's set-up, the warm stages (and, in the first run of a
checkout, the build of the kernel library)."""


def read(run):
    return run.setup_s
