"""Loading HiFi-GAN checkpoints into the port (audio_calm_torch.models
.vocoder.load_vocoder, models.convert.load_torch_state_dict) vs the JAX
package's load_vocoder on the same file, on the CPU.

Each checkpoint is a tiny weight-normed torch generator of the published
architecture (an independent torch implementation, as the JAX package's
tests/test_vocoder.py builds it), saved as the official .bin, a
SpeechBrain-style directory, the newer `parametrizations` naming, and a
.safetensors file. Bound: 1e-4 max-abs (the JAX package's
test_hifigan_torch_parity bound); the port's vocoder is run with fp32
operands for it, and with its default bf16 operands within 5e-3, the JAX
package's bf16 vocoder bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from audio_calm_torch.config import HiFiGANConfig as THiFiGANConfig
from audio_calm_torch.models.convert import (load_torch_state_dict,
                                             read_safetensors)
from audio_calm_torch.models.vocoder import GriffinLimVocoder as TGriffinLim
from audio_calm_torch.models.vocoder import HiFiGANVocoder as TVocoder
from audio_calm_torch.models.vocoder import load_vocoder as t_load_vocoder
from audio_calm_tpu.models.vocoder import HiFiGANConfig
from audio_calm_tpu.models.vocoder import load_vocoder


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread each runs them in well
    under a millisecond, where a full pool of threads per worker waits on
    the others."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


GEOM = dict(in_channels=8, upsample_initial_channel=32, upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
            resblock_dilations=((1, 2), (1, 2)))


def _torch_generator(cfg, norm):
    """The published HiFi-GAN generator with `norm` (weight_norm of
    torch.nn.utils or of torch.nn.utils.parametrizations) on every conv."""

    class Res(nn.Module):
        def __init__(self, ch, k, dil):
            super().__init__()
            self.convs1 = nn.ModuleList(
                norm(nn.Conv1d(ch, ch, k, dilation=d, padding=d * (k - 1) // 2))
                for d in dil)
            self.convs2 = nn.ModuleList(
                norm(nn.Conv1d(ch, ch, k, padding=(k - 1) // 2)) for _ in dil)

    class Gen(nn.Module):
        def __init__(self):
            super().__init__()
            ch = cfg.upsample_initial_channel
            self.conv_pre = norm(nn.Conv1d(cfg.in_channels, ch, 7, padding=3))
            self.ups = nn.ModuleList()
            self.resblocks = nn.ModuleList()
            for r, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
                self.ups.append(norm(nn.ConvTranspose1d(
                    ch, ch // 2, k, r, padding=(k - r) // 2)))
                ch //= 2
                for rk, rd in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilations):
                    self.resblocks.append(Res(ch, rk, rd))
            self.conv_post = norm(nn.Conv1d(ch, 1, 7, padding=3))

    with torch.random.fork_rng():
        torch.manual_seed(0)
        gen = Gen().eval()
        # weight norm's g starts at ||v||: move it, so folding matters
        for name, p in gen.named_parameters():
            if name.endswith(("weight_g", "original0")):
                p.data.mul_(1.0 + 0.5 * torch.rand_like(p))
    return gen


def _mel(cfg, seed=1, T=6):
    return np.random.default_rng(seed).standard_normal(
        (2, T, cfg.in_channels)).astype(np.float32)


def _compare(path, cfg, tcfg):
    """Port vs JAX load_vocoder on `path`: fp32 within 1e-4, the port's
    default bf16 operands within 5e-3."""
    mel = _mel(cfg)
    ref = np.asarray(load_vocoder(str(path), cfg)(jnp.asarray(mel)))
    voc = t_load_vocoder(str(path), tcfg, device="cpu")
    assert isinstance(voc, TVocoder) and voc.compute_dtype == torch.bfloat16
    with torch.no_grad():
        out = TVocoder(voc.generator, compute_dtype=torch.float32)(
            torch.from_numpy(mel)).numpy()
        out_bf = voc(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 6 * cfg.total_upsample)
    assert np.abs(ref).max() > 0.05  # a live waveform
    assert np.max(np.abs(out - ref)) < 1e-4
    assert np.max(np.abs(out_bf - ref)) < 5e-3


@pytest.fixture(scope="module")
def cfgs():
    return HiFiGANConfig(**GEOM), THiFiGANConfig(**GEOM)


def test_load_vocoder_bin_file(tmp_path, cfgs):
    gen = _torch_generator(cfgs[0], nn.utils.weight_norm)
    torch.save(gen.state_dict(), tmp_path / "generator.bin")
    _compare(tmp_path / "generator.bin", *cfgs)


def test_load_vocoder_speechbrain_dir(tmp_path, cfgs):
    """generator.ckpt with wrapper-prefixed keys, found in a directory."""
    gen = _torch_generator(cfgs[0], nn.utils.weight_norm)
    torch.save({"generator." + k: v for k, v in gen.state_dict().items()},
               tmp_path / "generator.ckpt")
    (tmp_path / "hyperparams.yaml").write_text("unused: 1\n")
    _compare(tmp_path, *cfgs)


def test_load_vocoder_parametrizations_naming(tmp_path, cfgs):
    gen = _torch_generator(cfgs[0], nn.utils.parametrizations.weight_norm)
    sd = gen.state_dict()
    assert any(".parametrizations.weight.original1" in k for k in sd)
    torch.save(sd, tmp_path / "model.pt")
    _compare(tmp_path / "model.pt", *cfgs)


def test_load_vocoder_safetensors(tmp_path, cfgs):
    from safetensors.numpy import save_file

    gen = _torch_generator(cfgs[0], nn.utils.weight_norm)
    save_file({k: v.numpy() for k, v in gen.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    _compare(tmp_path / "model.safetensors", *cfgs)
    _compare(tmp_path, *cfgs)  # the directory's last candidate name


def test_read_safetensors_dtypes(tmp_path):
    """F32, F16, BF16 and I64 (and an empty tensor) read back exactly."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 2, 3, generator=g).bfloat16(),
        "i64": torch.arange(-4, 8, dtype=torch.int64).reshape(3, 4),
        "empty": torch.zeros(0, 4),
    }
    save_file(tensors, str(tmp_path / "t.safetensors"),
              metadata={"format": "pt"})
    for read in (read_safetensors, load_torch_state_dict):
        got = read(str(tmp_path / "t.safetensors"))
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def test_load_vocoder_falls_back_to_griffin_lim(tmp_path, capsys):
    assert isinstance(t_load_vocoder(None, device="cpu"), TGriffinLim)
    for path in (tmp_path / "missing.bin", tmp_path):
        voc = t_load_vocoder(str(path), device="cpu")
        assert isinstance(voc, TGriffinLim)
        assert "falling back to Griffin-Lim" in capsys.readouterr().out
    assert voc.inv_fb.device.type == "cpu" and voc.n_iter == 32
