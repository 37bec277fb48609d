"""Engine: host wall inside Engine.run_group over the window's tts
groups, divided by the rows they served, in ms."""

KERNELS = ()


def read(run):
    groups = run.window_groups()
    rows = sum(g.rows for g in groups)
    if not rows:
        return None
    return 1e3 * sum(g.t1 - g.t0 for g in groups) / rows
