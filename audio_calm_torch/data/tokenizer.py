"""Tokenizers (counterpart of audio_calm_tpu/data/tokenizer.py).

`ByteTokenizer` only: UTF-8 bytes shifted by 2 (0 = pad, 1 = EOS), with the
ChatML end marker "<|im_end|>" encoded as EOS. The BPE tokenizer of the
JAX package (`TiktokenTokenizer`) is still to be ported: it needs a rank
file and the `regex` module.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    pad_token_id = 0
    eos_token_id = 1
    vocab_size = 258

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for chunk in text.split("<|im_end|>"):
            ids.extend(b + 2 for b in chunk.encode("utf-8"))
            ids.append(self.eos_token_id)
        return ids[:-1]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if 2 <= t < 258:
                out.append(t - 2)
            elif not skip_special_tokens and t == self.eos_token_id:
                out.extend(b"<|im_end|>")
        return out.decode("utf-8", errors="replace")
