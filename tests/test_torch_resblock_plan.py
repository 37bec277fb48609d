"""Host side of the bf16 resblock kernel (K6, csrc/resblock.cu) on the CPU.

The kernel copies its weights into a shared-memory ring as one stream of
tap images, laid out by the wrapper, and launches with a plan computed in
ops/vocoder_kernel.py. Neither can be run here (the kernel needs the card;
tests/test_torch_kernels_cuda.py holds it against its plain twin), so these
tests hold the host side to what the kernel's source documents:
  - `resblock_plan`: a pure function of (C, k, dilations, T), never of the
    batch; its shared memory fits a block at every width, kernel and 1-4
    dilations, or the halo leaves no tile and it raises ValueError; k is
    padded to 16 and N is the width itself; the windows cover [0, T) once;
  - its per-width table is the kernel's (`Width` in the source);
  - `resblock_stream`: decoding each tap image by the documented core-matrix
    addressing gives back every weight exactly, in the order the kernel
    consumes the images (dilation, conv, pass, tap);
  - `resblock_products` and `candidate_plans`.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_calm_torch.ops import vocoder_kernel as vk
from audio_calm_torch.ops.vocoder_kernel import (_RESBLOCK_WIDTHS, _halo,
                                                 candidate_plans,
                                                 resblock_plan,
                                                 resblock_products,
                                                 resblock_stream, simt_plan)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
DILATIONS = [(1,), (1, 3), (1, 3, 5), (1, 3, 5, 7)]
WIDTHS = [12, 24, 48, 96, 128, 192, 256]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A shared CPU runs tiny torch ops far faster on one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("dils", DILATIONS, ids=str)
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", WIDTHS)
def test_plan_fits_shared_memory_or_names_the_halo(C, k, dils):
    """Every plan fits the 232,448 bytes a block may use and holds a ring
    stage more than the taps in flight; where the window the registers hold is no wider than
    twice the halo, the plan raises ValueError naming the halo."""
    W = next(w for w in _RESBLOCK_WIDTHS if w >= C)
    rows = 64 * vk._RESBLOCK_CONSUMERS * _RESBLOCK_WIDTHS[W][2]
    if rows - 2 * _halo(k, dils) < 1:
        with pytest.raises(ValueError, match="halo"):
            resblock_plan(C, k, dils, 10 ** 6)
        return
    for T in (1, 100, 10 ** 6):
        p = resblock_plan(C, k, dils, T)
        assert p.smem <= SMEM_LIMIT
        assert vk._RESBLOCK_INFLIGHT < p.stages <= vk._RESBLOCK_MAX_RING
        assert p.margin == (k - 1) // 2 * max(dils)
        assert p.smem == (vk._RESBLOCK_HEADER + p.stages * 2 * p.kpad * p.split
                          + 2 * 16 * p.margin + 2 * rows * p.kpad * 2)
        assert p.Lp % 64 == 0 and p.Lp <= rows and p.tile == p.Lp - 2 * p.halo
        assert p.tile >= 1


@pytest.mark.parametrize("C,width,kpad", [(24, 24, 32), (48, 48, 48),
                                          (96, 96, 96), (12, 16, 16),
                                          (128, 128, 128), (200, 256, 256)])
def test_k_padded_to_16_and_n_unpadded(C, width, kpad):
    """The odd widths run unpadded in N (the width is C itself) and padded
    in k only to a multiple of 16; other widths take the next kernel width.
    Padding alone executes KP W / C^2 the useful products: 1.0 at 48 and
    96, 1.33 at 24."""
    p = resblock_plan(C, 11, (1, 3, 5), 10 ** 6)
    assert (p.width, p.kpad) == (width, kpad)
    assert p.kpad % 16 == 0 and p.width % p.split == 0 and p.split % 8 == 0
    if C in (48, 96):
        assert p.kpad * p.width == C * C
    if C == 24:
        assert p.kpad * p.width / (C * C) == pytest.approx(4 / 3)


def test_plan_inputs_exclude_the_batch():
    """The plan takes (C, k, dilations, T) and nothing else, so row b of a
    batch runs the same schedule as the row launched alone."""
    assert list(inspect.signature(resblock_plan).parameters) == [
        "C", "k", "dils", "T"]
    assert resblock_plan(96, 7, (1, 3, 5), 5000) == resblock_plan(
        96, 7, [1, 3, 5], 5000)


def test_halo_raises_as_before():
    with pytest.raises(ValueError, match="halo"):
        resblock_plan(256, 11, (1, 9, 11, 13), 100)
    with pytest.raises(ValueError, match="halo"):
        simt_plan(256, 11, (1, 9, 11, 13), 100)


@pytest.mark.parametrize("C,k", [(24, 3), (96, 11), (256, 7)])
def test_windows_cover_the_sequence_once(C, k):
    """Block i writes rows [i tile, (i + 1) tile) of [0, T): the tiles of
    ceil(T / tile) blocks cover every row once, and a short sequence takes
    a window of the rows it needs, rounded up to 64."""
    for T in (1, 63, 64, 65, 1000, 12345):
        p = resblock_plan(C, k, (1, 3, 5), T)
        n = -(-T // p.tile)
        covered = np.zeros(T, int)
        for i in range(n):
            covered[i * p.tile:min(T, (i + 1) * p.tile)] += 1
        assert (covered == 1).all()
        rows = 64 * vk._RESBLOCK_CONSUMERS * p.groups
        assert p.Lp == min(rows, -(-(T + 2 * p.halo) // 64) * 64)


def _kernel_widths():
    """The `Width` specializations of csrc/resblock.cu: {W: (KP, NN, R)}."""
    src = (Path(vk.__file__).parent.parent / "csrc" / "resblock.cu").read_text()
    pat = (r"template <> struct Width<(\d+)> \{ static constexpr int "
           r"KP = (\d+), NN = (\d+), R = (\d+); \};")
    return {int(m[0]): tuple(int(v) for v in m[1:])
            for m in re.findall(pat, src)}


def test_width_table_is_the_kernels():
    """The wrapper's copy of the per-width table is the kernel's (the
    library also reports it on load: `_resblock_lib`), and every width's
    registers stay within the budget the design assumes: R (W + NN) / 2
    fp32 of residual and accumulator a thread, at most 192."""
    assert _kernel_widths() == _RESBLOCK_WIDTHS
    src = (Path(vk.__file__).parent.parent / "csrc" / "resblock.cu").read_text()
    assert f"kNC = {vk._RESBLOCK_CONSUMERS};" in src
    assert f"kMaxStages = {vk._RESBLOCK_MAX_RING};" in src
    assert f"kInflight = {vk._RESBLOCK_INFLIGHT};" in src
    assert f"kHeader = {vk._RESBLOCK_HEADER};" in src
    for W, (KP, NN, R) in _RESBLOCK_WIDTHS.items():
        assert KP == -(-W // 16) * 16 and W % NN == 0
        assert R * (W + NN) // 2 <= 192


def _decode(flat, n_d, k, W, KP, NN):
    """[n_d, 2, k, KP, W] from a stream by the addressing of
    csrc/resblock.cu `b_desc`: per (dilation, conv, pass, tap) an image of
    KP NN elements, element (ci, co) at (ci // 8) 8 NN + (co // 8) 64 +
    (ci % 8) 8 + co % 8, co counted within the pass."""
    flat = flat.float().numpy()
    out = np.empty((n_d, 2, k, KP, W), np.float32)
    unit = KP * NN
    ci, co = np.indices((KP, NN))
    offs = (ci // 8) * 8 * NN + (co // 8) * 64 + (ci % 8) * 8 + co % 8
    u = 0
    for i in range(n_d):
        for conv in range(2):
            for p in range(W // NN):
                for j in range(k):
                    out[i, conv, j, :, p * NN:(p + 1) * NN] = \
                        flat[u * unit:(u + 1) * unit][offs]
                    u += 1
    assert u * unit == flat.size
    return out


@pytest.mark.parametrize("C", [12, 24, 32, 48, 64, 96, 128, 192, 256])
def test_stream_decodes_to_the_weights(C):
    """Every tap image decodes to its conv's weights (bf16 values: exact),
    zero in the padded channels, in the kernel's consumption order."""
    n_d, k = 2, 3
    g = np.random.default_rng(C)
    w1, w2 = (torch.tensor(g.standard_normal((n_d, k, C, C)),
                           dtype=torch.float32).to(torch.bfloat16)
              for _ in range(2))
    p = resblock_plan(C, k, (1, 3), 10 ** 4)
    flat = resblock_stream(w1, w2, p)
    assert flat.dtype == torch.bfloat16
    assert flat.numel() == 2 * n_d * k * p.kpad * p.width
    got = _decode(flat, n_d, k, p.width, p.kpad, p.split)
    want = np.zeros_like(got)
    want[:, 0, :, :C, :C] = w1.float().numpy()
    want[:, 1, :, :C, :C] = w2.float().numpy()
    np.testing.assert_array_equal(got, want)


def test_products_reckoning():
    """Executed over useful multiply-adds of a full block: the 64-row
    groups the warpgroups own, every conv, times k KP W, over 2 n_d tile k
    C^2: at C = 96 the 256-row window's 4 groups in each of 6 convs."""
    p = resblock_plan(96, 3, (1, 3, 5), 10 ** 6)
    executed, useful = resblock_products(p, 96, 3, (1, 3, 5))
    assert executed == 6 * 4 * 64 * 3 * 96 * 96
    assert useful == 2 * 3 * p.tile * 3 * 96 * 96
    p = resblock_plan(24, 11, (1, 3, 5), 10 ** 6)
    executed, useful = resblock_products(p, 24, 11, (1, 3, 5))
    assert executed / useful > 4 / 3  # the k padding and the halo


def test_candidate_plans():
    """resblock_plan's choice first, smaller windows after it, and at
    width 24 the width padded to 32; every candidate fits a block."""
    plans = candidate_plans(24, 11, (1, 3, 5), 393216)
    assert plans[0] == resblock_plan(24, 11, (1, 3, 5), 393216)
    assert [p.Lp for p in plans[1:3]] == [plans[0].Lp - 64,
                                          plans[0].Lp - 128]
    assert plans[-1].width == 32
    for C in WIDTHS:
        for p in candidate_plans(C, 7, (1, 3, 5), 10 ** 6):
            assert p.smem <= SMEM_LIMIT and p.tile >= 1
