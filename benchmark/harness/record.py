"""What a run leaves for the per-layer metrics to read: the window, every
request, the recorded groups, spans and rows, the trace, and the
configuration. A metric (benchmark/metrics/<name>.py) reads only this."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from benchmark.harness.client import Sent
from benchmark.harness.serve import GroupRec, Recorder, Row
from benchmark.harness.trace import Trace
from benchmark.reference.text import chunk_seeds, prompt_ids
from benchmark.reference.tts import chunks


@dataclass
class RunRecord:
    conf: dict
    mix: dict
    kind: str  # the card's name
    t0: float  # the window, perf_counter seconds
    t1: float
    sent: List[Sent]
    rec: Recorder
    trace: Optional[Trace] = None
    setup_s: float = 0.0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def window_groups(self) -> List[GroupRec]:
        """The tts groups that ended inside the window."""
        return [g for g in self.rec.groups
                if g.key == "tts" and self.t0 <= g.t1 <= self.t1]

    def group_rows(self, g: GroupRec) -> List[Row]:
        return [self.rec.rows[s] for s in g.seeds if s in self.rec.rows]

    @staticmethod
    def shape(row: Row) -> Tuple[int, int]:
        """(prompt tokens L, frames n) of a row."""
        return len(prompt_ids(row.text)), row.n_frames

    def request_rows(self, sent: Sent) -> List[Row]:
        parts = chunks(self.conf, sent.req.text)
        return [self.rec.rows[s] for s in chunk_seeds(sent.req.seed,
                                                      len(parts))
                if s in self.rec.rows]

    def spans(self, name: str):
        """{group index: (ns0, ns1)} of the named span, for the groups
        whose span lies inside the traced slice."""
        if self.trace is None:
            return {}
        return {s.group: (s.ns0, s.ns1) for s in self.rec.spans
                if s.name == name and s.ns0 >= self.trace.ns0
                and s.ns1 <= self.trace.ns1}
