"""The port's WER / CER (audio_calm_torch.eval.metrics) and its `.pt` ->
`.npz` store converter (audio_calm_torch.data.convert_store) vs the JAX
package's eval/metrics.py and scripts/convert_store.py, on the CPU.

Metrics: equal on 200 seeded string pairs (integer edit distances, and
ratios of the same integers). The converter: the single-host cases of
tests/test_convert_store.py, and sidecars array-equal to the JAX script's
on a copy of the same store."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from audio_calm_torch.data import convert_store
from audio_calm_torch.data.datasets import CalmDataset, load_array
from audio_calm_torch.eval import metrics as tmetrics
from audio_calm_tpu.eval import metrics as jmetrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import convert_store as jconvert_store  # noqa: E402

LATENT_DIM = 8
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far",
         "Hello,", "world!", "it's", "fine"]


def _pairs(n=200, seed=0):
    rng = np.random.default_rng(seed)

    def sentence():
        return " ".join(WORDS[i] for i in rng.integers(
            0, len(WORDS), rng.integers(0, 9)))

    return [(sentence(), sentence()) for _ in range(n)]


def test_metrics_match_jax_on_seeded_pairs():
    pairs = _pairs()
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    for r, h in pairs:
        assert tmetrics.normalize_text(r) == jmetrics.normalize_text(r)
        for a, b in ((r.split(), h.split()), (list(r), list(h))):
            assert tmetrics.edit_distance(a, b) == \
                jmetrics.edit_distance(a, b)
    assert tmetrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert tmetrics.cer(refs, hyps) == jmetrics.cer(refs, hyps)
    norm = [tmetrics.normalize_text(s) for s in refs]
    assert tmetrics.wer(refs, norm) == jmetrics.wer(refs, norm)
    assert tmetrics.edit_distance(list("kitten"), list("sitting")) == 3
    assert tmetrics.wer([""], ["a b"]) == 2.0


class _ByteTok:
    pad_token_id = 0

    def encode(self, text, add_special_tokens=False):
        return [(ord(c) % 60) + 1 for c in text]


def _pt_store(root, n=24, seed=0, corrupt=()):
    """Reference-layout store: {"latent": (D, T)} torch payloads."""
    d = os.path.join(root, "dev", "1")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        fid = f"1-{i:04d}"
        path = os.path.join(d, fid + ".pt")
        if i in corrupt:
            with open(path, "wb") as f:
                f.write(b"not a torch file")
        else:
            T = int(rng.integers(4, 17))
            lat = rng.standard_normal((T, LATENT_DIM)).astype(np.float32)
            torch.save({"latent": torch.from_numpy(lat.T)}, path)
        lines.append(f"{fid} sample number {i} {'pad ' * (i % 4)}")
    with open(os.path.join(d, "1.trans.txt"), "w") as f:
        f.write("\n".join(lines))
    return root


def _dataset(root, task_mode):
    return CalmDataset(
        _ByteTok(), asr_latent_dir=root, asr_subsets="dev",
        tts_latent_dir=root, tts_subsets="dev",
        max_text_len=16, max_audio_len=24, task_mode=task_mode,
        latent_dim=LATENT_DIM)


def test_convert_store_roundtrip_and_meta(tmp_path, capsys):
    """tests/test_convert_store.py's roundtrip: sidecars load equal to the
    .pt originals (the (D, T) transpose included) and to the JAX script's,
    a corrupt file is counted, a rerun skips, the dataset regains header
    metadata; a truncated sidecar is rewritten."""
    root = _pt_store(str(tmp_path / "s"), corrupt=(5,))
    jroot = str(tmp_path / "j")
    shutil.copytree(root, jroot)
    assert not _dataset(root, "mix").supports_meta("asr")

    assert convert_store.main(["--root", root, "--dim",
                               str(LATENT_DIM)]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converted"] == 23 and out["failed"] == 1
    assert jconvert_store.main(["--root", jroot, "--dim",
                                str(LATENT_DIM)]) == 1
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in out.items() if k != "root"} == \
        {k: v for k, v in jout.items() if k != "root"}
    for i in range(24):
        if i == 5:
            continue
        pt = os.path.join(root, "dev", "1", f"1-{i:04d}.pt")
        npz = pt[:-3] + ".npz"
        arr = np.load(npz)["latent"]
        assert arr.shape[1] == LATENT_DIM  # canonical (T, D)
        np.testing.assert_array_equal(
            arr, load_array(pt, expected_dim=LATENT_DIM))
        np.testing.assert_array_equal(arr, np.load(os.path.join(
            jroot, "dev", "1", f"1-{i:04d}.npz"))["latent"])

    ds = _dataset(root, "mix")
    assert ds.supports_meta("asr") and ds.supports_meta("tts")
    bad = next(i for i, it in enumerate(ds.asr_items)
               if "1-0005" in it["file_path"])
    assert ds.meta("asr", bad) is None

    convert_store.main(["--root", root, "--dim", str(LATENT_DIM)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["skipped"] == 23 and out["converted"] == 0

    trunc = os.path.join(root, "dev", "1", "1-0007.npz")
    with open(trunc, "r+b") as f:
        f.truncate(10)
    convert_store.main(["--root", root, "--dim", str(LATENT_DIM)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converted"] == 1 and out["skipped"] == 22
    np.testing.assert_array_equal(
        np.load(trunc)["latent"],
        load_array(trunc[:-4] + ".pt", expected_dim=LATENT_DIM))


def test_convert_square_ambiguous_layout(tmp_path):
    """A (D, T) payload whose T is a known channel count converts right
    when --dim is given, as the JAX script's does."""
    d = str(tmp_path)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((128, 8)).astype(np.float32)  # (T, D)
    for name in ("a", "b"):
        torch.save({"latent": torch.from_numpy(lat.T)},
                   os.path.join(d, f"{name}.pt"))
    convert_store.convert_file(os.path.join(d, "a.pt"), expected_dim=8)
    jconvert_store.convert_file(os.path.join(d, "b.pt"), expected_dim=8)
    np.testing.assert_array_equal(np.load(os.path.join(d, "a.npz"))["latent"],
                                  lat)
    np.testing.assert_array_equal(np.load(os.path.join(d, "b.npz"))["latent"],
                                  lat)
    with pytest.raises(ValueError, match="no"):
        torch.save({"other": torch.zeros(2, 2)}, os.path.join(d, "c.pt"))
        convert_store.convert_file(os.path.join(d, "c.pt"))
    assert not os.path.exists(os.path.join(d, "c.npz"))
