"""Front end and batcher: the mean rows of the tts groups that ended in
the window (the span around Engine.run_group)."""

KERNELS = ()


def read(run):
    groups = run.window_groups()
    if not groups:
        return None
    return sum(g.rows for g in groups) / len(groups)
