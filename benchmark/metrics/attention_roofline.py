"""The attention kernels (csrc/attention_fwd.cu, K3 / K4, and any SDPA or
flash kernel a later path routes to): the least time the attention of the
groups' rows needs at their own lengths (Qwen2's causal attention over
[prompt | SOA], the DiT's self-attention over the row's frames and its
cross-attention to the prompt's states, for every velocity evaluation and
both CFG halves; a call at a time, bf16 q / k / v / o), over the device time
of the kernels named below inside the tts_batch spans of the traced slice,
in %."""

import re

from benchmark.harness.trace import inside
from benchmark.work import tts as W
from benchmark.work.peaks import bound_s

KERNELS = (r"\battention_kernel\b", r"flash", r"fmha", r"sdpa",
           r"efficient_attention", r"scaled_dot_product")


def read(run):
    spans = run.spans("tts_batch")
    if not spans:
        return None
    need = 0.0
    for g in spans:
        rows = [run.shape(r) for r in run.group_rows(run.rec.groups[g])]
        need += sum(bound_s(f, b, run.kind)
                    for f, b in W.attention_calls(run.conf, rows))
    pat = re.compile("|".join(KERNELS))
    spent = sum(e - s for name, s, e in inside(run.trace.kernels,
                                               spans.values())
                if pat.search(name)) * 1e-9
    return None if not spent else 100.0 * need / spent
