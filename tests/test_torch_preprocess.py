"""The port's data preparation (audio_calm_torch.data.preprocess and the
process_dataset CLI) vs the JAX package's (audio_calm_tpu.data.preprocess)
on the same LibriSpeech-layout corpus, fp32 on the CPU: the preprocess
cases of tests/test_data_pipeline.py, each against the JAX result.

Bounds: audio, resampling, transcripts, file lists and statistics of the
same arrays equal (the same numpy arithmetic; the JAX package's optional
C decoder gives the same floats); log-mel 1e-3 mean-abs (tests/
test_torch_mel.py's, the JAX package's own); latents 2e-4 (tests/
test_torch_vae.py's: seven convs and GroupNorms in fp32, summed in another
order)."""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_calm_torch.data import preprocess as tpre
from audio_calm_torch.data import process_dataset
from audio_calm_torch.data.datasets import load_array
from audio_calm_tpu.data import preprocess as jpre


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _write_wav(path, n=8000, sr=16000, freq=440):
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


@pytest.fixture()
def corpus(tmp_path):
    """tests/test_data_pipeline.py's corpus: one LibriSpeech chapter."""
    root = tmp_path / "raw" / "dev-clean" / "1" / "2"
    root.mkdir(parents=True)
    with open(root / "1-2.trans.txt", "w") as f:
        for i in range(5):
            fid = f"1-2-{i:04d}"
            _write_wav(str(root / f"{fid}.wav"), n=4000 + 2000 * i)
            f.write(f"{fid} sample text number {i}\n")
    return tmp_path


def _npz(root):
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if f.endswith(".npz"))


def _trans(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".trans.txt"):
                with open(os.path.join(dp, f)) as fh:
                    out[os.path.relpath(os.path.join(dp, f), root)] = \
                        fh.read()
    return out


def test_load_audio_and_resample(corpus, tmp_path):
    p = str(corpus / "raw" / "dev-clean" / "1" / "2" / "1-2-0000.wav")
    x, sr = tpre.load_audio(p)
    jx, jsr = jpre.load_audio(p)
    assert sr == jsr == 16000 and x.shape == (4000,) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    for target in (8000, 22050):
        np.testing.assert_array_equal(tpre.resample_linear(x, 16000, target),
                                      jpre.resample_linear(jx, 16000, target))
    assert abs(len(tpre.resample_linear(x, 16000, 8000)) - 2000) <= 1
    np.testing.assert_array_equal(tpre.peak_normalize(x),
                                  jpre.peak_normalize(jx))
    assert abs(tpre.peak_normalize(x).max() - 0.95) < 0.01
    # stereo 8-bit: the mono mix
    st = tmp_path / "st.wav"
    with wave.open(str(st), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(1)
        w.setframerate(22050)
        w.writeframes(np.arange(64, dtype=np.uint8).tobytes())
    y, ysr = tpre.load_audio(str(st))
    assert ysr == 22050 and y.shape == (32,)
    np.testing.assert_array_equal(y, (np.arange(64).reshape(-1, 2)
                                      .astype(np.float32) - 128.0).mean(1)
                                  / 128.0)


def test_text_resolvers(corpus, tmp_path):
    p = str(corpus / "raw" / "dev-clean" / "1" / "2" / "1-2-0003.wav")
    assert tpre.librispeech_text(p) == jpre.librispeech_text(p) == \
        "sample text number 3"
    assert tpre.librispeech_text(str(tmp_path / "x.wav")) is None
    d = tmp_path / "ltts"
    d.mkdir()
    _write_wav(str(d / "a.wav"))
    (d / "a.normalized.txt").write_text("hello norm")
    assert tpre.libritts_text(str(d / "a.wav")) == \
        jpre.libritts_text(str(d / "a.wav")) == "hello norm"
    tsv = tmp_path / "dev.tsv"
    tsv.write_text("client_id\tpath\tsentence\n1\ta.mp3\tone two\n"
                   "2\tb.mp3\t\n3\tc.mp3\tthree\n")
    assert tpre.commonvoice_map(str(tsv)) == jpre.commonvoice_map(str(tsv))\
        == {"a.mp3": "one two", "c.mp3": "three"}
    root = str(corpus / "raw")
    assert tpre.scan_audio_files(root) == jpre.scan_audio_files(root)
    assert len(tpre.scan_audio_files(root)) == 5


def test_corpus_processor_mel_only(corpus, tmp_path):
    in_root = str(corpus / "raw")
    files = tpre.scan_audio_files(in_root)
    out, jout = str(tmp_path / "mels"), str(tmp_path / "jmels")
    proc = tpre.CorpusProcessor(batch_size=2, device="cpu")
    stats = proc.process_corpus(files, out, in_root,
                                text_resolver=tpre.librispeech_text)
    jpre.CorpusProcessor(batch_size=2).process_corpus(
        files, jout, in_root, text_resolver=jpre.librispeech_text)
    assert stats.processed == 5 and stats.failed == 0
    ours, refs = _npz(out), _npz(jout)
    assert len(ours) == 5
    assert [os.path.relpath(p, out) for p in ours] == \
        [os.path.relpath(p, jout) for p in refs]
    for a, b in zip(ours, refs):
        m, r = (load_array(p, key_priority=("mel",)) for p in (a, b))
        assert m.shape == r.shape and m.shape[1] == 80
        assert np.mean(np.abs(m - r)) < 1e-3
        assert m.min() >= np.log(1e-5) - 1e-5
    assert _trans(out) == _trans(jout)
    assert len(next(iter(_trans(out).values())).splitlines()) == 5
    stats2 = proc.process_corpus(files, out, in_root,
                                 text_resolver=tpre.librispeech_text)
    assert stats2.skipped == 5 and stats2.processed == 0


def test_corpus_processor_with_vae(corpus, tmp_path):
    """Latents through JAX's VAE and through the port's with the same
    weights (carried across by from_jax_params), as process_dataset
    feeds them: the normalized log-mel's encoder means."""
    from audio_calm_torch.config import VAEModelConfig as TVAEConfig
    from audio_calm_torch.models.convert import load_vae
    from audio_calm_torch.models.vae import AcousticVAE as TVAE
    from audio_calm_torch.models.vae import normalize_mel
    from audio_calm_tpu.config import VAEModelConfig
    from audio_calm_tpu.models.vae import AcousticVAE

    geom = dict(hidden_channels=32, latent_channels=8, norm_num_groups=4)
    m = AcousticVAE(VAEModelConfig(**geom))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: 0.1 * rng.standard_normal(s.shape).astype(np.float32),
        jax.eval_shape(lambda: m.init(
            {"params": jax.random.PRNGKey(0),
             "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, 16, 80)), train=False)["params"]))
    tm = TVAE(TVAEConfig(**geom)).eval()
    load_vae(tm, params)
    cfg = VAEModelConfig(**geom)

    def jax_vae(mel):
        mu, _ = m.apply({"params": params}, (mel - cfg.mel_mean)
                        / cfg.mel_std, method=AcousticVAE.encode)
        return mu

    def port_vae(mel):
        return tm.encode(normalize_mel(mel, tm.cfg))[0]

    in_root = str(corpus / "raw")
    files = tpre.scan_audio_files(in_root)
    out, jout = str(tmp_path / "lat"), str(tmp_path / "jlat")
    st = tpre.CorpusProcessor(vae_apply=port_vae, total_stride=4,
                              batch_size=3, device="cpu").process_corpus(
        files, out, in_root, text_resolver=tpre.librispeech_text)
    jpre.CorpusProcessor(vae_apply=jax_vae, total_stride=4,
                         batch_size=3).process_corpus(
        files, jout, in_root, text_resolver=jpre.librispeech_text)
    assert st.processed == 5
    for a, b in zip(_npz(out), _npz(jout)):
        lat, ref = (load_array(p, key_priority=("latent",)) for p in (a, b))
        assert lat.shape == ref.shape and lat.shape[1] == 8
        assert np.max(np.abs(lat - ref)) < 2e-4
    assert _trans(out) == _trans(jout)


def test_compute_stats(corpus, tmp_path):
    in_root = str(corpus / "raw")
    out = str(tmp_path / "mels")
    tpre.CorpusProcessor(batch_size=4, device="cpu").process_corpus(
        tpre.scan_audio_files(in_root), out, in_root)
    files = _npz(out)
    for per_dim in (False, True):
        mean, std = tpre.compute_stats(files, per_dim=per_dim)
        jmean, jstd = jpre.compute_stats(files, per_dim=per_dim)
        np.testing.assert_array_equal(mean, jmean)
        np.testing.assert_array_equal(std, jstd)
        assert np.all(np.isfinite(mean)) and np.all(std > 0)
        assert mean.shape == ((80,) if per_dim else ())


def test_sharded_corpus_processing_merges_transcripts(corpus, tmp_path,
                                                       capsys):
    """Two shard jobs of the CLI (files[i::2]) into one store, against the
    JAX processor's two shard jobs: the same files, the merged
    transcripts equal; then the CLI's --stats over the store."""
    in_root = str(corpus / "raw")
    out, jout = str(tmp_path / "sharded"), str(tmp_path / "jsharded")
    files = jpre.scan_audio_files(in_root)
    for shard in (0, 1):
        rc = process_dataset.main([
            "--input_dir", in_root, "--output_dir", out, "--mel_only",
            "--batch_size", "2", "--num_shards", "2", "--shard_id",
            str(shard), "--device", "cpu"])
        assert rc == 0
        jpre.CorpusProcessor(batch_size=2).process_corpus(
            files[shard::2], jout, in_root,
            text_resolver=jpre.librispeech_text)
    assert [os.path.relpath(p, out) for p in _npz(out)] == \
        [os.path.relpath(p, jout) for p in _npz(jout)]
    assert len(_npz(out)) == 5
    trans = _trans(out)
    assert trans == _trans(jout) and len(trans) == 1
    lines = next(iter(trans.values())).splitlines()
    assert sorted(ln.split(" ", 1)[0] for ln in lines) == \
        [f"1-2-{i:04d}" for i in range(5)]
    capsys.readouterr()
    assert process_dataset.main(["--stats", out]) == 0
    printed = capsys.readouterr().out
    mean, std = jpre.compute_stats(_npz(out), key_priority=("mel",))
    assert "files: 5" in printed and f"mean: {float(mean)}" in printed
    assert f"std:  {float(std)}" in printed
