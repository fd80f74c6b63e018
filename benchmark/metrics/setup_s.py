"""setup_s: seconds from the process's start to the first timed chunk:
imports, the card's context, building or loading the kernels, making the
inputs, the runner and its warm-up call."""


def read(run):
    return run["setup_s"]
