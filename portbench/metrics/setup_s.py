"""setup_s: process start to the first timed request (imports, the kernel
library, the system's start, warm-up)."""


def read(run):
    return run.setup_s
