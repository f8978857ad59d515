"""setup_s: seconds from the start of the process to the first timed call:
imports, CUDA start-up, the kernel library (built on a checkout's first
run, loaded after), the weights, the scene pool and one warm-up call on
each pool scene."""


def read(run):
    return run.setup_s
