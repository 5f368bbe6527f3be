"""setup_s: seconds from the process's start to the first timed call (inputs, build, warm-up)."""


def read(run):
    return run.setup_s
