"""setup_s: seconds from the process's start to the window's first
operation (imports, the kernel library, the inputs, the warm-up)."""


def read(run):
    return run.setup_s
