"""The device: the share of the traced slice in which no kernel, copy or
set ran (the union of CUDA activity from torch.profiler), in %."""

KERNELS = ()


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
