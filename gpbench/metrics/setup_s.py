"""setup_s: seconds from the process's start to the window's start (loading,
the first run's nvcc build, data, warm-up)."""


def read(run):
    return run.setup_s
