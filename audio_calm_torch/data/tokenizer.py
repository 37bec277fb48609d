"""Tokenizers (counterpart of audio_calm_tpu/data/tokenizer.py).

`TiktokenTokenizer` reads the Qwen2 BPE from a tiktoken rank file
(base64(token bytes) -> rank a line; byte-level BPE under the Qwen2
pre-tokenization regex; ChatML special tokens at 151643+), so the shipped
token model runs with no network and no HF tokenizer checkout. It needs
the third-party `regex` module (for `\\p{L}`), imported when a tokenizer is
built, so this module imports without it.

`ByteTokenizer` is the fallback for tokenizer-less runs (tests, the
card's smoke run): UTF-8 bytes shifted by 2 (0 = pad, 1 = EOS), with the
ChatML end marker "<|im_end|>" encoded as EOS.
"""

from __future__ import annotations

import base64
import re
from typing import Dict, List, Optional

# Qwen2 pre-tokenization regex (HF tokenizer.json pretokenizer)
QWEN2_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
    r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# ChatML controls (EOS set {151643, 151645})
QWEN2_SPECIAL_TOKENS = {
    "<|endoftext|>": 151643,
    "<|im_start|>": 151644,
    "<|im_end|>": 151645,
}


class TiktokenTokenizer:
    """Qwen2 BPE from a tiktoken rank file: the `tiktoken` encoder when it
    imports, else a pure-Python greedy lowest-rank merge (the same
    algorithm). The interface the pipeline needs of an HF tokenizer:
    encode / decode / pad_token_id / eos_token_id / vocab_size."""

    def __init__(self, path: str, vocab_size: int = 151936):
        ranks: Dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                tok_b64, rank = line.split()
                ranks[base64.b64decode(tok_b64)] = int(rank)
        self._ranks = ranks
        self._decode_map = {r: b for b, r in ranks.items()}
        self._special = dict(QWEN2_SPECIAL_TOKENS)
        self._special_by_id = {v: k for k, v in self._special.items()}
        self.vocab_size = max(vocab_size, max(self._special.values()) + 1)
        self.pad_token_id = self._special["<|endoftext|>"]
        self.eos_token_id = self._special["<|im_end|>"]
        import regex

        self._pat = regex.compile(QWEN2_SPLIT_PATTERN)
        self._spec_pat = re.compile("(" + "|".join(
            re.escape(s) for s in sorted(self._special, key=len,
                                         reverse=True)) + ")")
        self._enc = None
        try:
            import tiktoken

            self._enc = tiktoken.Encoding(
                "qwen2", pat_str=QWEN2_SPLIT_PATTERN, mergeable_ranks=ranks,
                special_tokens=self._special)
        except Exception:
            # no tiktoken, or a rank file it refuses: the pure-Python path
            # below, as in the JAX package
            self._enc = None

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        if self._enc is not None:
            return self._enc.encode(text, allowed_special=set(self._special))
        return self._encode_py(text)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if t in self._special_by_id:
                if not skip_special_tokens:
                    out.extend(self._special_by_id[t].encode())
            elif t in self._decode_map:
                out.extend(self._decode_map[t])
        return out.decode("utf-8", errors="replace")

    def _bpe(self, piece: bytes) -> List[int]:
        r = self._ranks.get(piece)
        if r is not None:
            return [r]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank: Optional[int] = None
            best_i = -1
            for i in range(len(parts) - 1):
                rr = self._ranks.get(parts[i] + parts[i + 1])
                if rr is not None and (best_rank is None or rr < best_rank):
                    best_rank, best_i = rr, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self._ranks[p] for p in parts]

    def _encode_py(self, text: str) -> List[int]:
        ids: List[int] = []
        # special-token literals first, longest first
        for chunk in self._spec_pat.split(text):
            if not chunk:
                continue
            if chunk in self._special:
                ids.append(self._special[chunk])
                continue
            for piece in self._pat.findall(chunk):
                ids.extend(self._bpe(piece.encode("utf-8")))
        return ids


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


def load_tokenizer(model_cfg, byte_fallback: bool = False):
    """One tokenizer policy for every entry point: byte_fallback (the
    `--byte-tokenizer` flag) > model.tokenizer_path (a tiktoken rank file).
    The JAX package's last resort, an HF AutoTokenizer at model.qwen_path,
    has no counterpart here: without either, this raises."""
    if byte_fallback:
        return ByteTokenizer()
    path = getattr(model_cfg, "tokenizer_path", None)
    if path:
        return TiktokenTokenizer(path)
    raise ValueError(
        "no tokenizer: the port has no HF AutoTokenizer; set "
        "model.tokenizer_path to a tiktoken rank file or pass "
        "--byte-tokenizer")
