"""The whole model step on the card: the operations the rows of the
window's tts groups need (benchmark/work/tts.py, each row at its own
prompt length and frame count, both CFG halves, no padding) over the
window's seconds times the card's dense bf16 peak, in %."""

from benchmark.work import tts as W
from benchmark.work.peaks import peak

KERNELS = ()


def read(run):
    flops = 0.0
    for g in run.window_groups():
        for row in run.group_rows(g):
            L, n = run.shape(row)
            flops += W.row_flops(run.conf, L, n)
    if not flops:
        return None
    return 100.0 * flops / (run.seconds * peak(run.kind)["bf16_flops"])
