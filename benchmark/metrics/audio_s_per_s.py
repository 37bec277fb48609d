"""Seconds of audio in the replies completed inside the window, over the
window's seconds (host clock)."""

KERNELS = ()


def read(run):
    audio = sum(s.audio_s() for s in run.sent
                if s.ok and run.t0 <= s.done <= run.t1)
    return audio / run.seconds if audio else None
