"""Set-up time: from the benchmark's start to its window's start, that is
the imports and library loads, making the clouds from the seed and
writing them, and the warm-up of every shape the mix uses (kernels built
or loaded from the checkout's build cache there)."""

UNIT = "s"


def read(run):
    return run.setup["setup_s"]
