"""The port's tokenizers (audio_calm_torch/data/tokenizer.py) vs the JAX
package's on a rank file the test writes (the repo holds none): ids equal
on the tiktoken path and the pure-Python merge path, decodes equal, ChatML
specials, and the selection policy of load_tokenizer, which raises where
the JAX package would fall back to an HF AutoTokenizer."""

import base64

import pytest

from audio_calm_torch.config import CALMModelConfig as TCALMConfig
from audio_calm_torch.data import tokenizer as ttok
from audio_calm_tpu.config import CALMModelConfig
from audio_calm_tpu.data import tokenizer as jtok

TEXTS = ["hello", "abc abc", "xyz!", "ababab", "hello, hello world 123",
         "<|im_start|>user\nRead this text:\nhello<|im_end|>\n",
         "héllo wörld — ünïcode", "  spaces   and\nnew\r\nlines  "]


@pytest.fixture(scope="module")
def rank_file(tmp_path_factory):
    """256 byte tokens and a few merges, each the concatenation of two
    earlier tokens (tests/test_tokenizer.py's tiny vocabulary)."""
    lines = [f"{base64.b64encode(bytes([b])).decode()} {b}"
             for b in range(256)]
    for rank, tok in enumerate((b"ab", b"abc", b"he", b"ll", b"llo",
                                b"hello", b" w", b"or", b"ld"), 256):
        lines.append(f"{base64.b64encode(tok).decode()} {rank}")
    path = tmp_path_factory.mktemp("tok") / "tiny.tiktoken"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def both(rank_file):
    return ttok.TiktokenTokenizer(rank_file), jtok.TiktokenTokenizer(rank_file)


@pytest.mark.parametrize("text", TEXTS)
def test_ids_match_jax(both, text):
    port, ref = both
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port._encode_py(text) == ref._encode_py(text) == ids
    assert port.decode(ids) == ref.decode(ids)
    assert (port.decode(ids, skip_special_tokens=False)
            == ref.decode(ids, skip_special_tokens=False) == text)


def test_merges_and_specials(both):
    port, _ = both
    assert port.encode("hello") == [port._ranks[b"hello"]]
    ids = port.encode("<|im_start|>hello<|im_end|>")
    assert ids[0] == 151644 and ids[-1] == 151645
    assert port.decode(ids) == "hello"
    assert (port.pad_token_id, port.eos_token_id,
            port.vocab_size) == (151643, 151645, 151936)


def test_byte_tokenizer_matches_jax():
    text = "<|im_start|>user\nhi<|im_end|>\n<|im_end|>é"
    port, ref = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    assert port.encode(text) == ref.encode(text)
    ids = ref.encode(text)
    for skip in (True, False):
        assert port.decode(ids, skip) == ref.decode(ids, skip)


def test_load_tokenizer_policy(rank_file):
    assert isinstance(ttok.load_tokenizer(TCALMConfig(), byte_fallback=True),
                      ttok.ByteTokenizer)
    tok = ttok.load_tokenizer(TCALMConfig(tokenizer_path=rank_file))
    ref = jtok.load_tokenizer(CALMModelConfig(tokenizer_path=rank_file))
    assert isinstance(tok, ttok.TiktokenTokenizer)
    assert tok.encode(TEXTS[4]) == ref.encode(TEXTS[4])
    # the JAX package would load an HF AutoTokenizer at qwen_path here
    with pytest.raises(ValueError, match="byte-tokenizer"):
        ttok.load_tokenizer(TCALMConfig(qwen_path="qwen2_1.5B_Instruct"))
