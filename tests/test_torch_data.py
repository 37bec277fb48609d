"""The port's data pipeline vs the JAX package's, on the CPU: the synthetic
store writer, the latent store reader, SpecAugment and the ASR pack plan,
the batch iterator (TTS, ASR and the mix of both, plain and packed), the
prefetch thread, and the VAE's mel crops and batches.

Bounds: none. Every comparison is exact (array_equal with equal dtypes,
equal lists): the pipeline is numpy and host code on the same files and
seeds.
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_calm_torch.data import collator as tcol
from audio_calm_torch.data import datasets as tds
from audio_calm_torch.data import synth_corpus
from audio_calm_torch.data.prefetch import prefetch
from audio_calm_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from audio_calm_tpu.data import collator as jcol
from audio_calm_tpu.data import datasets as jds
from audio_calm_tpu.data.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]
LAT = 8


def _script_main():
    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus", REPO / "scripts" / "make_synth_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A synthetic TTS store by the port's writer, with a few files made
    odd: a corrupt npz, a reference-style .pt payload ({"latent": (D, T)})
    and an npy stored (D, T)."""
    root = tmp_path_factory.mktemp("store")
    argv = ["--asr-n", "0", "--tts-n", "40", "--dev-n", "6",
            "--latent-dim", str(LAT), "--chunk", "16", "--seed", "5"]
    assert synth_corpus.main(["--out", str(root)] + argv) == 0
    chunk = root / "train" / "LibriTTS_R" / "train-clean-100" / "0000"
    (chunk / "tts-train-000003.npz").write_bytes(b"not an npz")
    lat = np.load(chunk / "tts-train-000004.npz")["latent"]
    (chunk / "tts-train-000004.npz").unlink()
    torch.save({"latent": torch.from_numpy(lat.T.copy())},
               chunk / "tts-train-000004.pt")
    lat = np.load(chunk / "tts-train-000005.npz")["latent"]
    (chunk / "tts-train-000005.npz").unlink()
    np.save(chunk / "tts-train-000005.npy", lat.T.copy())
    return root, argv


def test_synth_corpus_writes_the_scripts_files(store, tmp_path, capsys):
    """For one seed the port's writer and scripts/make_synth_corpus.py
    write the same files: transcripts byte for byte, arrays equal."""
    _, argv = store
    ours, theirs = tmp_path / "port", tmp_path / "script"
    assert synth_corpus.main(["--out", str(ours)] + argv) == 0
    assert _script_main()(["--out", str(theirs)] + argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].replace(str(ours), "") == out[1].replace(str(theirs), "")
    files = _files(ours)
    assert files == _files(theirs) and len(files) == 46 + 4
    for f in files:
        a, b = ours / f, theirs / f
        if f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert za.files == zb.files == ["latent"]
            assert za["latent"].dtype == zb["latent"].dtype == np.float32
            np.testing.assert_array_equal(za["latent"], zb["latent"])
        else:
            assert a.read_bytes() == b.read_bytes(), f


def _datasets(root, split="train", subsets="train-clean-100", **kw):
    args = dict(tts_latent_dir=str(root / split / "LibriTTS_R"),
                tts_subsets=subsets, max_text_len=48, max_audio_len=64,
                task_mode="tts", latent_dim=LAT, **kw)
    return (tds.CalmDataset(TByteTokenizer(), **args),
            jds.CalmDataset(ByteTokenizer(), **args))


def test_calm_dataset_matches_jax(store):
    root, _ = store
    tset, jset = _datasets(root)
    assert len(tset) == len(jset) == 40
    assert tset.tts_items == jset.tts_items
    np.testing.assert_array_equal(tset.asr_prompt_ids, jset.asr_prompt_ids)
    for i in range(len(tset)):
        assert tset.meta("tts", i) == jset.meta("tts", i), i
        a, b = tset.get("tts", i), jset.get("tts", i)
        if b is None:  # the corrupt file
            assert a is None and i == 3
            continue
        assert a.mode == b.mode == "tts"
        for k in ("input_ids", "labels", "audio"):
            x, y = getattr(a, k), getattr(b, k)
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert tset.supports_meta("tts") == jset.supports_meta("tts") is True
    assert tset.meta("tts", 4) is None  # .pt has no cheap header
    assert tset.get("tts", 4).audio.shape[1] == LAT  # (D, T) transposed
    assert tset.get("tts", 5).audio.shape[1] == LAT
    for path in sorted(Path(root).rglob("*.np[yz]")):
        for dim in (None, LAT):
            assert tds.array_frames(str(path), expected_dim=dim) == \
                jds.array_frames(str(path), expected_dim=dim)
    for shape in [(8, 300), (300, 8), (128, 64), (64, 128), (80, 80)]:
        for dim in (None, 8, 128, 80):
            assert tds._is_dt_layout(shape, dim) == jds._is_dt_layout(
                shape, dim)
    cap = dict(max_samples=7)
    assert len(_datasets(root, **cap)[0]) == len(_datasets(root, **cap)[1])


ITER_CASES = {
    "plain": dict(batch_size=4),
    "bucketed": dict(batch_size=4, audio_buckets=[64, 16, 32]),
    "grouped": dict(batch_size=3, audio_buckets=[16, 32, 48, 64],
                    length_group_window=3),
    "packed": dict(batch_size=4, audio_buckets=[32, 64],
                   tts_pack_rows=2, tts_pack_len=120, tts_pack_segments=3),
    "packed_grouped": dict(batch_size=4, audio_buckets=[16, 32, 48, 64],
                           length_group_window=2, tts_pack_rows=2,
                           tts_pack_len=110, tts_pack_segments=2),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_tts_batch_iterator_matches_jax(store, case):
    """Two epochs of training batches (and one eval pass): the same
    batches, in the same order, as the JAX iterator with the same seed."""
    root, _ = store
    tset, jset = _datasets(root)
    kw = dict(ITER_CASES[case], pad_token_id=0, latent_dim=LAT, seed=17,
              task_prob_tts=1.0)
    for training, epochs in ((True, 2), (False, 1)):
        got = list(tcol.calm_batch_iterator(tset, training=training,
                                            epochs=epochs, **kw))
        ref = list(jcol.calm_batch_iterator(jset, training=training,
                                            epochs=epochs, **kw))
        assert len(got) == len(ref) > 2
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            assert a["task"] == b["task"] == (
                "tts_packed" if "packed" in case else "tts")
            assert a.get("n_samples") == b.get("n_samples")
            for k in a:
                if k not in ("task", "n_samples"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype, k


def test_iterator_refuses_what_is_not_ported(store):
    """What JAX refuses the port refuses too: a global batch that does not
    split over the processes, no full batch, packed rows too short for a
    segment."""
    root, _ = store
    tset, _ = _datasets(root)
    with pytest.raises(ValueError, match="not divisible by 3"):
        next(tcol.calm_batch_iterator(tset, 4, 0, LAT, process_count=3))
    with pytest.raises(ValueError, match="no full batch"):
        next(tcol.calm_batch_iterator(tset, 64, 0, LAT))
    with pytest.raises(ValueError, match="cannot fit"):
        next(tcol.calm_batch_iterator(tset, 4, 0, LAT, tts_pack_rows=2,
                                      tts_pack_len=40))
    with pytest.raises(ValueError, match="cannot fit"):
        next(tcol.calm_batch_iterator(tset, 4, 0, LAT, asr_pack_rows=2,
                                      asr_pack_len=100))


# --------------------------------------------------------------------------
# the ASR stream
# --------------------------------------------------------------------------
def _asr_examples(lengths, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(input_ids=np.asarray([5, 6, 7], np.int32),
                labels=rng.integers(1, 200, int(rng.integers(1, 12))).astype(
                    np.int32),
                audio=rng.standard_normal((n, LAT)).astype(np.float32),
                mode="asr") for n in lengths]


def test_asr_packing_and_spec_augment_match_jax():
    """spec_augment (short inputs untouched, the generators left in the
    same state), pack_asr_window with SpecAugment per slot, and
    materialize_asr_rows with failed loads: array-equal to JAX's."""
    for T, seed in ((20, 0), (21, 1), (64, 2), (300, 3)):
        a = np.random.default_rng(seed).standard_normal((T, LAT)).astype(
            np.float32)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        got, ref = tcol.spec_augment(a, ra), jcol.spec_augment(a, rb)
        np.testing.assert_array_equal(got, ref)
        assert (got is a) == (ref is a) == (T <= 20)
        assert ra.random() == rb.random()
    prompt = np.asarray([5, 6, 7], np.int32)
    lengths = [16, 4, 10, 7, 15, 3, 2, 12, 30, 25]
    tex = _asr_examples(lengths, 1, tds.CalmExample)
    jex = _asr_examples(lengths, 1, jds.CalmExample)
    for training in (False, True):
        ra, rb = np.random.default_rng(7), np.random.default_rng(7)
        got, left = tcol.pack_asr_window(tex, prompt, 3, 60, 3, 24, LAT, 8,
                                         training=training, rng=ra)
        ref, jleft = jcol.pack_asr_window(jex, prompt, 3, 60, 3, 24, LAT,
                                          max_text_len=8, training=training,
                                          rng=rb)
        assert left == jleft and left
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k
    rows_t = [[tex[0], None, tex[2]], [None, tex[1], None]]
    rows_j = [[jex[0], None, jex[2]], [None, jex[1], None]]
    got = tcol.materialize_asr_rows(rows_t, prompt, 60, 3, 24, LAT, 8,
                                    training=True,
                                    rng=np.random.default_rng(3))
    ref = jcol.materialize_asr_rows(rows_j, prompt, 60, 3, 24, LAT, 8,
                                    training=True,
                                    rng=np.random.default_rng(3))
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="cannot fit"):
        tcol.pack_asr_window(tex, prompt, 3, 27, 3, 24, LAT, 8)


@pytest.fixture(scope="module")
def mixed_store(tmp_path_factory):
    """A synthetic store with both tasks (ASR utterances capped at 64
    frames, the byte tokenizer's 76-token ASR prompt)."""
    root = tmp_path_factory.mktemp("mixed")
    assert synth_corpus.main([
        "--out", str(root), "--asr-n", "36", "--tts-n", "36", "--dev-n", "4",
        "--latent-dim", str(LAT), "--chunk", "12", "--seed", "9"]) == 0
    return root


def _mixed_datasets(root, task_mode):
    args = dict(asr_latent_dir=str(root / "train" / "LibriSpeech"),
                asr_subsets="train-clean-100",
                tts_latent_dir=str(root / "train" / "LibriTTS_R"),
                tts_subsets="train-clean-100", max_text_len=96,
                max_audio_len=64, task_mode=task_mode, latent_dim=LAT)
    return (tds.CalmDataset(TByteTokenizer(), **args),
            jds.CalmDataset(ByteTokenizer(), **args))


PACK_ASR = dict(asr_pack_rows=2, asr_pack_len=300, asr_pack_segments=3)
PACK_TTS = dict(tts_pack_rows=2, tts_pack_len=200, tts_pack_segments=3)
MIX_CASES = {
    "asr_plain": ("asr", dict(batch_size=4, asr_text_pad=32,
                              audio_buckets=[64, 16, 32, 48])),
    "asr_grouped": ("asr", dict(batch_size=3, asr_text_pad=90,
                                audio_buckets=[16, 32, 48, 64],
                                length_group_window=2)),
    "asr_packed": ("asr", dict(batch_size=4, **PACK_ASR)),
    "mix_plain": ("mix", dict(batch_size=4, asr_text_pad=32,
                              audio_buckets=[32, 64], length_group_window=2)),
    # calm.yaml's data settings, both streams packed
    "mix_packed": ("mix", dict(batch_size=4, asr_text_pad=32,
                               audio_buckets=[16, 32, 48, 64],
                               length_group_window=2, **PACK_ASR,
                               **PACK_TTS)),
}


@pytest.mark.parametrize("case", sorted(MIX_CASES))
def test_asr_and_mix_iterators_match_jax(mixed_store, case):
    """Two epochs of training batches (SpecAugmented) and one eval pass:
    the same batches and the same task sequence as the JAX iterator with
    the same seed; the mix draws both tasks."""
    task_mode, kw = MIX_CASES[case]
    tset, jset = _mixed_datasets(mixed_store, task_mode)
    assert len(tset.asr_items) == len(jset.asr_items) == 36
    for i in range(len(tset.asr_items)):
        a, b = tset.get("asr", i), jset.get("asr", i)
        for k in ("input_ids", "labels", "audio"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    kw = dict(kw, pad_token_id=0, latent_dim=LAT, seed=23,
              task_prob_tts=0.5 if task_mode == "mix" else 0.0)
    for training, epochs in ((True, 2), (False, 1)):
        got = list(tcol.calm_batch_iterator(tset, training=training,
                                            epochs=epochs, **kw))
        ref = list(jcol.calm_batch_iterator(jset, training=training,
                                            epochs=epochs, **kw))
        tasks = [b["task"] for b in got]
        assert tasks == [b["task"] for b in ref] and len(tasks) > 2
        want = {"asr_packed" if "asr_pack_rows" in kw else "asr"}
        if task_mode == "mix":
            want.add("tts_packed" if "tts_pack_rows" in kw else "tts")
        assert set(tasks) == want
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            assert a.get("n_samples") == b.get("n_samples")
            for k in a:
                if k not in ("task", "n_samples"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype, k


def test_prefetch_keeps_order_and_passes_errors():
    def slow(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("producer failed")
            time.sleep(0.001 * (i % 3))
            yield {"i": i}

    assert [b["i"] for b in prefetch(slow(50), buffer_size=3)] == \
        list(range(50))
    seen = []
    with pytest.raises(KeyError, match="producer failed"):
        for b in prefetch(slow(10, fail_at=6), buffer_size=2):
            seen.append(b["i"])
    assert seen == list(range(6))  # every item made before the error
    assert list(prefetch(iter(()))) == []
    # a consumer that stops early ends the producer thread
    before = threading.active_count()
    it = prefetch(slow(1000), buffer_size=2)
    assert next(it)["i"] == 0
    assert threading.active_count() == before + 1
    it.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# --------------------------------------------------------------------------
# the VAE's mel store
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mel_store(tmp_path_factory):
    """Two subsets of mel files: npz [T, 80] around a 32-frame crop, one
    short (zero-padded), one corrupt (a failed load), one npy stored
    (80, T) and one reference .pt {"mel": (80, T)}."""
    root = tmp_path_factory.mktemp("mels")
    rng = np.random.default_rng(2)
    for s, subset in enumerate(("train-a", "train-b")):
        d = root / subset / "spk" / "ch"
        d.mkdir(parents=True)
        for i in range(9):
            T = int(rng.integers(20, 60))
            mel = (rng.standard_normal((T, 80)) * 2 - 6).astype(np.float32)
            name = f"u{s}{i:02d}"
            if i == 3:
                (d / f"{name}.npz").write_bytes(b"not an npz")
            elif i == 4:
                np.save(d / f"{name}.npy", mel.T.copy())
            elif i == 5:
                torch.save({"mel": torch.from_numpy(mel.T.copy())},
                           d / f"{name}.pt")
            else:
                np.savez(d / f"{name}.npz", mel=mel)
    return root


def _mel_sets(root, training, **kw):
    args = (str(root), "train-a, train-b", 32)
    return (tds.MelDataset(*args, training=training, **kw),
            jds.MelDataset(*args, training=training, **kw))


def test_mel_dataset_matches_jax(mel_store):
    """The files (sorted glob order per subset and extension, max_samples)
    and every crop: random from the caller's generator when training, the
    centre one in eval, a short mel zero-padded, a failed load raising."""
    for training in (True, False):
        tset, jset = _mel_sets(mel_store, training)
        assert tset.files == jset.files and len(tset) == 18
        ra, rb = np.random.default_rng(4), np.random.default_rng(4)
        for i in range(len(tset)):
            if tset.files[i].endswith("03.npz"):  # the corrupt files
                with pytest.raises(Exception):
                    tset.get(i, ra)
                with pytest.raises(Exception):
                    jset.get(i, rb)
                continue
            a, b = tset.get(i, ra), jset.get(i, rb)
            assert a.shape == (32, 80) and a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert _mel_sets(mel_store, True, max_samples=5)[0].files == \
        _mel_sets(mel_store, True, max_samples=5)[1].files[:5]


@pytest.mark.parametrize("training", [True, False])
def test_mel_batch_iterator_matches_jax(mel_store, training):
    """Two training epochs (or one eval pass) of batches of 4: the same
    batches in the same order as JAX's for the same seed, the batches with
    the failed load skipped."""
    tset, jset = _mel_sets(mel_store, training)
    kw = dict(batch_size=4, training=training, seed=11,
              epochs=2 if training else 1)
    got = list(tcol.mel_batch_iterator(tset, **kw))
    ref = list(jcol.mel_batch_iterator(jset, **kw))
    assert len(got) == len(ref) >= 3
    for a, b in zip(got, ref):
        assert set(a) == set(b) == {"mel"}
        assert a["mel"].shape == (4, 32, 80) and a["mel"].dtype == np.float32
        np.testing.assert_array_equal(a["mel"], b["mel"])


def test_mel_iterator_refuses_an_empty_epoch_and_multi_host():
    """tests/test_data_pipeline.py's empty-epoch check in the port: a
    training epoch with no full batch raises, eval ends quietly; a
    multi-host global batch that does not split over the processes
    raises."""

    class _TinyMels:
        crop_size = 16

        def __len__(self):
            return 3

        def get(self, idx, rng=None):
            return np.zeros((16, 80), np.float32)

    it = tcol.mel_batch_iterator(_TinyMels(), batch_size=8, training=True,
                                 seed=0, epochs=None)
    with pytest.raises(ValueError, match="no full batch"):
        next(it)
    assert list(tcol.mel_batch_iterator(_TinyMels(), batch_size=8,
                                        training=False, seed=0,
                                        epochs=1)) == []
    with pytest.raises(ValueError, match="not divisible by 2"):
        next(tcol.mel_batch_iterator(_TinyMels(), 3, process_count=2))
