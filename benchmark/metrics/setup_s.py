"""From the process's start to the window's first request: the weights
drawn, the kernels loaded (built, in a checkout's first run), the engine
and server made, every shape of the cell warmed."""

KERNELS = ()


def read(run):
    return run.setup_s
