"""setup_s: seconds from the process's start to the window's start (loading,
building or loading the kernels, the inputs, warming up, calibrating)."""


def read(run):
    return run.setup_s
