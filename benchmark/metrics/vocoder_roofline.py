"""K1, the vocoder stage kernel (csrc/vocoder_stage.cu): the least time
the HiFi-GAN stages it runs need for the rendered rows' own frames (the
larger of FLOP / peak and bytes / bandwidth, a call at a time; fp32
activations in and out, bf16 weights), over the device time of the kernels
named below inside the renders of the traced slice, in %."""

import re

from benchmark.harness.trace import inside
from benchmark.work import tts as W
from benchmark.work.peaks import bound_s

KERNELS = (r"\bstage_kernel\b",)


def read(run):
    spans = run.spans("render")
    if not spans:
        return None
    need = 0.0
    for g in spans:
        rows = [run.shape(r) for r in run.group_rows(run.rec.groups[g])]
        need += sum(bound_s(f, b, run.kind)
                    for f, b in W.group_vocoder_calls(run.conf, rows))
    pat = re.compile("|".join(KERNELS))
    spent = sum(e - s for name, s, e in inside(run.trace.kernels,
                                               spans.values())
                if pat.search(name)) * 1e-9
    return None if not spent else 100.0 * need / spent
