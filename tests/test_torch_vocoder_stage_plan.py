"""Host side of the bf16 stage kernel (K1, csrc/vocoder_stage.cu) on the CPU.

The kernel reads its weights as one stream of k16 slice images, copied into
shared memory as they are, and launches with a tile plan computed in
ops/vocoder_kernel.py. Neither can be run here (the kernel needs the card;
tests/test_torch_kernels_cuda.py holds it against its plain twin), so these
tests hold the host side to what the kernel's source documents:
  - `_smem_slices`: decoding the image by the documented addressing gives
    back every weight exactly (bf16 weights, so the cast is exact);
  - `weight_stream`: slice g of the stream is the slice the warps consume
    g-th (per resblock the upsample's phases, then conv1, conv2 per
    dilation);
  - `stage_plan`: for every width HiFi-GAN V1 and V2 run through the kernel
    and T from 1 to several tiles, the tiles cover [0, T_out) once, the
    shared memory fits a block, and the tile is at least one m16 unit.
"""

import numpy as np
import pytest
import torch

from audio_calm_torch.ops.vocoder_kernel import (_SMEM_BYTES, _smem_slices,
                                                 stage_halo, stage_plan,
                                                 weight_stream)
from chip_smoke import stage_reckoning

V1_GEOM = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))
# (C, r) of every stage the kernel runs: V1 128 grouped, 128 -> 64 and
# 64 -> 32 with the upsample; V2 64 and 32 grouped, 32 -> 16 and 16 -> 8
# zero-padded to 32 with the upsample
WIDTHS = [(128, 1), (64, 2), (32, 2), (64, 1), (32, 1)]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
PASS_ROWS = {32: 1152, 64: 512, 128: 256}  # Layout<C>::kRows


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A shared CPU runs tiny torch ops far faster on one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bf16_weights(k, c_in, c_out, seed):
    w = np.random.default_rng(seed).standard_normal((k, c_in, c_out))
    return torch.tensor(w, dtype=torch.float32).to(torch.bfloat16)


def _decode(flat, k, c_in, c_out):
    """[k, c_in, c_out] from a slice-image stream by the addressing of
    csrc/vocoder_stage.cu `slice_chunk`: element (j, ci, co) at
    ((j * c_in/16 + ci // 16) * 16 + kr) * c_out + pos * 8 + co % 8, with
    kr = ci % 16 and pos = co // 8 XOR (kr % 8 if c_out >= 64 else
    (kr // 2) % 4)."""
    flat = flat.float().numpy()
    out = np.empty((k, c_in, c_out), np.float32)
    for j in range(k):
        for ci in range(c_in):
            kr = ci % 16
            swz = kr % 8 if c_out >= 64 else (kr // 2) % 4
            for co in range(0, c_out, 8):
                pos = (co // 8) ^ swz
                at = ((j * c_in // 16 + ci // 16) * 16 + kr) * c_out + pos * 8
                out[j, ci, co:co + 8] = flat[at:at + 8]
    return out


@pytest.mark.parametrize("C,c_in,k", [(C, C, k) for C in (32, 64, 128)
                                      for k in (3, 7, 11)]
                         + [(C, 2 * C, 4) for C in (32, 64, 128)])
def test_slice_image_decodes_to_the_weights(C, c_in, k):
    """Every conv's W (and the upsample's, C_in = 2C, k_up = 4) comes back
    exactly from its packed image."""
    w = _bf16_weights(k, c_in, C, seed=C + k)
    packed = _smem_slices(w)
    assert packed.dtype == torch.bfloat16 and packed.numel() == w.numel()
    np.testing.assert_array_equal(_decode(packed, k, c_in, C), w.float())


def _stage_weights(C, ups, seed):
    ups_w = _bf16_weights(4, 2 * C, C, seed) if ups else None
    blocks = []
    for i, (k, dils) in enumerate(V1_GEOM):
        n = len(dils)
        blocks.append((_bf16_weights(n * k, C, C, seed + 10 * i + 1)
                       .reshape(n, k, C, C), None,
                       _bf16_weights(n * k, C, C, seed + 10 * i + 2)
                       .reshape(n, k, C, C), None, k, dils))
    return ups_w, blocks


@pytest.mark.parametrize("C,ups", [(128, False), (64, True), (32, True)])
def test_weight_stream_is_in_consumption_order(C, ups):
    """Slice g of the stream is the g-th the warps take: per resblock, the
    upsample's kernel rows per output phase ph ((ph + p) % r + r i, p = 1
    for k_up = 4, r = 2), then per dilation conv1's and conv2's taps."""
    r = 2
    ups_w, blocks = _stage_weights(C, ups, seed=C)
    stream = weight_stream(ups_w, blocks, r)
    slice_elems = 16 * C
    at = 0

    def take(k, c_in):
        nonlocal at
        n = k * c_in // 16 * slice_elems
        out = _decode(stream[at:at + n], k, c_in, C)
        at += n
        return out

    for w1, _, w2, _, k, dils in blocks:
        if ups:
            rows = [(ph + 1) % r + r * i for ph in range(r) for i in range(2)]
            np.testing.assert_array_equal(take(4, 2 * C),
                                          ups_w.float()[rows])
        for i in range(len(dils)):
            np.testing.assert_array_equal(take(k, C), w1[i].float())
            np.testing.assert_array_equal(take(k, C), w2[i].float())
    assert at == stream.numel()


@pytest.mark.parametrize("C,r", WIDTHS)
def test_tile_plan_covers_and_fits(C, r):
    """For T_out from 1 to a few tiles: the tiles cover [0, T_out) exactly
    once, shared memory stays within a block's 227 KB, the tile is at least
    one m16 unit, the window one pass of the accumulators, and the
    upsample's staged input fits in the bf16 operand buffer."""
    halo = stage_halo(V1_GEOM, r)
    assert halo == 60
    full = stage_plan(C, r, V1_GEOM, 1 << 20)
    for T_out in list(range(r, 3 * full.tile + 2 * r, 7 * r)) + [r]:
        plan = stage_plan(C, r, V1_GEOM, T_out, B=2)
        n = plan.grid[0]
        assert plan.grid[1] == 2
        assert (n - 1) * plan.tile < T_out <= n * plan.tile, (T_out, plan)
        assert plan.smem <= SMEM_LIMIT and _SMEM_BYTES == SMEM_LIMIT
        assert plan.tile == plan.Lp - 2 * halo >= 16 * r
        assert plan.Lp % (16 * r) == 0 and plan.Lp <= PASS_ROWS[C]
        assert 2 <= plan.stages <= 16
        assert plan.smem == 256 + plan.stages * 64 * C + plan.Lp * (C + 8) * 6
        if r > 1:  # k_up = 4: Lp/r + 2 staged rows of 2C + 8 bf16
            assert (plan.Lp // r + 2) * (2 * C + 8) <= plan.Lp * (C + 8)
        assert plan.Lp <= full.Lp


@pytest.mark.parametrize("C,r,tile", [(128, 1, 136), (64, 2, 392),
                                      (32, 2, 808)])
def test_tile_plan_at_v1_widths(C, r, tile):
    """The windows the design note states: 256 / 512 / 928 rows, tiles
    136 / 392 / 808 (the earlier three-buffer design had 88 / 264 /
    584)."""
    plan = stage_plan(C, r, V1_GEOM, 98304)
    assert plan.tile == tile and plan.Lp == tile + 120


@pytest.mark.parametrize("C,C_in,r,k_up,T_out", [(128, 128, 1, 0, 98304),
                                                  (64, 128, 2, 4, 196608),
                                                  (32, 64, 2, 4, 393216),
                                                  (64, 128, 2, 4, 1000)])
def test_reckoning_counts_the_stream_and_the_tiles(C, C_in, r, k_up, T_out):
    """The L2 weight bytes a launch reckons are its blocks times the bytes
    of the weight stream; the executed products are at least the useful
    ones, and fewer than the window over the tile would give."""
    plan = stage_plan(C, r, V1_GEOM, T_out, B=2)
    ratio, l2_bytes = stage_reckoning(plan, C, C_in, r, k_up, V1_GEOM, T_out)
    ups_w, blocks = _stage_weights(C, k_up > 0, seed=1)
    stream = weight_stream(ups_w, blocks, r)
    assert l2_bytes == plan.grid[0] * plan.grid[1] * stream.numel() * 2
    rows = plan.grid[0] * plan.tile
    assert 1.0 <= ratio <= plan.Lp * rows / (plan.tile * T_out)
