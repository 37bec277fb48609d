"""Incremental WAV decoding for streaming ASR uploads (counterpart of
audio_calm_tpu/serving/wav_stream.py, copied: the JAX package's serving
package imports jax). The parser consumes arbitrary byte slices and emits
float32 mono samples as soon as whole frames are there, so transcription
can start while the client is still sending.
"""

import struct

import numpy as np

__all__ = ["WavStreamParser"]

# RIFF chunk sizes are often 0xFFFFFFFF (or 0) in live-encoded streams
# where the total length is unknown when the header is written
_UNBOUNDED = (0, 0xFFFFFFFF)


class WavStreamParser:
    """Stateful 16-bit PCM WAV decoder: feed(bytes) -> float32 samples.

    Parses the RIFF header incrementally (fmt/data plus any other chunks,
    e.g. LIST/JUNK, which are skipped), then converts each arriving whole
    frame; a trailing partial frame is held until the next feed. Streams
    with unknown-length data chunks (size 0 or 0xFFFFFFFF, as written by
    live encoders) decode until the transport ends.

    Strict by design for the real-time path: requires PCM16 at
    `require_rate` Hz (default 16 kHz, the model rate) — callers that want
    resampling use the buffered endpoint. Multi-channel input is averaged
    to mono like the server's parse_wav. Raises ValueError on a malformed
    header, non-PCM data, non-16-bit samples, or a rate mismatch.
    """

    def __init__(self, require_rate: int = 16000):
        self.require_rate = require_rate
        self._buf = b""
        self._state = "riff"  # riff -> chunks -> data
        self._channels = None
        self._data_left = None  # bytes of PCM remaining (None = unbounded)

    @property
    def in_data(self) -> bool:
        """True once the data chunk was reached (PCM is flowing)."""
        return self._state == "data"

    def feed(self, data: bytes) -> np.ndarray:
        """Consume a byte slice, return the newly decoded mono samples
        (possibly empty while the header is still arriving)."""
        self._buf += data
        if self._state == "riff":
            if len(self._buf) < 12:
                return np.zeros(0, np.float32)
            if self._buf[:4] != b"RIFF" or self._buf[8:12] != b"WAVE":
                raise ValueError("not a RIFF/WAVE stream")
            self._buf = self._buf[12:]
            self._state = "chunks"
        while self._state == "chunks":
            if len(self._buf) < 8:
                return np.zeros(0, np.float32)
            cid, size = self._buf[:4], struct.unpack(
                "<I", self._buf[4:8])[0]
            if cid == b"fmt ":
                if len(self._buf) < 8 + size:
                    return np.zeros(0, np.float32)
                fmt, ch, rate, _, _, bits = struct.unpack(
                    "<HHIIHH", self._buf[8:24])
                if fmt != 1:
                    raise ValueError(f"unsupported WAV format {fmt} "
                                     "(PCM required)")
                if bits != 16:
                    raise ValueError(f"unsupported sample width {bits} "
                                     "(16-bit required)")
                if rate != self.require_rate:
                    raise ValueError(
                        f"stream is {rate} Hz; streaming /asr requires "
                        f"{self.require_rate} Hz (use the buffered "
                        "endpoint for other rates)")
                self._channels = ch
                self._buf = self._buf[8 + size + (size & 1):]
            elif cid == b"data":
                if self._channels is None:
                    raise ValueError("data chunk before fmt chunk")
                self._data_left = None if size in _UNBOUNDED else size
                self._buf = self._buf[8:]
                self._state = "data"
            else:
                # skip unknown chunks (LIST, JUNK, fact, ...); RIFF pads
                # chunk bodies to even length
                if size in _UNBOUNDED:
                    raise ValueError(
                        f"unbounded {cid!r} chunk before data")
                if len(self._buf) < 8 + size + (size & 1):
                    return np.zeros(0, np.float32)
                self._buf = self._buf[8 + size + (size & 1):]
        # data state: emit whole frames, hold the partial tail
        take = len(self._buf)
        if self._data_left is not None:
            take = min(take, self._data_left)
        frame_bytes = 2 * self._channels
        take -= take % frame_bytes
        if take <= 0:
            return np.zeros(0, np.float32)
        raw, self._buf = self._buf[:take], self._buf[take:]
        if self._data_left is not None:
            self._data_left -= take
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if self._channels > 1:
            x = x.reshape(-1, self._channels).mean(axis=1)
        return x
