"""The fused Griffin-Lim CUDA kernel on the card, against its plain PyTorch
version; and one training step on the card against the CPU. Every test is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so that it runs where only the port is installed;
the tests directory's conftest imports JAX, so there run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances (see chip_smoke.py): one iteration seeded with the signal's own
STFT phases to 1e-3 of max|mag| per bin and 1e-3 relative Frobenius (f32
summation order, the projection's last ulp and the bf16 rounding flips
they cause); at 2 and 3 seeded iterations the per-bin bound grows with the
count (each projection amplifies the difference the one before left at
bins where |X2| nearly vanishes) and the Frobenius bound stays; whole
vocoder runs by spectral
convergence (SC) against the exact loop. Zero-magnitude pad frames of a
ragged batch must come out exactly zero.
"""

import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.stft import stft_np
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim, griffin_lim_masked
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as tgl

CFG = SignalConfig()


def spec_frames(n_frames, seed=0, f0=220.0):
    rng = np.random.default_rng(seed)
    n = CFG.hop_length * (n_frames - 1)
    t = np.arange(n) / CFG.sr
    y = (
        0.5 * np.sin(2 * np.pi * f0 * t)
        + 0.3 * np.sin(2 * np.pi * 2 * f0 * t) * np.exp(-2 * t)
        + 0.05 * rng.standard_normal(n)
    ).astype(np.float32)
    return stft_np(y, CFG.n_fft, CFG.hop_length, CFG.win_length)


def sc(mag, wav):
    est = np.abs(stft_np(np.asarray(wav), CFG.n_fft, CFG.hop_length, CFG.win_length))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(card):
    """Stacked blocks (two utterances, 100 frames: t_pad 104, M = 208 rows,
    not a multiple of the row tiles), one seeded iteration, and the launch
    counter."""
    S = np.stack([spec_frames(100, seed=0), spec_frames(100, seed=1)])
    mag = torch.from_numpy(np.abs(S).astype(np.float32)).to(card)
    init = torch.from_numpy(S).to(card)
    before = tgl.griffin_lim_phases.launches
    k = tgl.griffin_lim_phases(mag, CFG, n_iter=1, init_spec=init)
    p = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=1, init_spec=init)
    torch.cuda.synchronize()
    assert tgl.griffin_lim_phases.launches == before + 1
    assert float((k - p).abs().max()) <= 1e-3 * float(mag.max())
    assert float(torch.linalg.norm(k - p) / torch.linalg.norm(p)) <= 1e-3


def ragged_batch(lengths, t):
    """Blocks (len(lengths), n_freq, t) complex, zero past each block's length."""
    return np.stack([
        np.pad(spec_frames(n, seed=k), ((0, 0), (0, t - n))) for k, n in enumerate(lengths)
    ])


# (blocks, frames per block): row counts that straddle the 64-, 128- and
# 256-row tiles, and one 128-row tile past the serving grid's 4096
EDGE_SHAPES = [(1, 8), (1, 136), (2, 104), (1, 392), (27, 152)]


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,frames", EDGE_SHAPES)
@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_kernel_at_tile_edges_and_short_loops(card, blocks, frames, n_iter):
    """n_iter 1 (the first iteration is the last: the only one that stores
    the f32 state), 2 and 3 (the operand buffers reused once and twice), at
    8, 136, 208, 392 and 4104 rows, seeded with the signal's own phases;
    and the plan the kernel took is the Python model's."""
    S = np.stack([spec_frames(frames, seed=k) for k in range(blocks)])
    mag = torch.from_numpy(np.abs(S).astype(np.float32)).to(card)
    init = torch.from_numpy(S).to(card)
    k = tgl.griffin_lim_phases(mag, CFG, n_iter=n_iter, init_spec=init)
    assert tgl.kernel_last_plan() == tgl.launch_plan(blocks * frames)
    p = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=n_iter, init_spec=init)
    torch.cuda.synchronize()
    assert torch.isfinite(k.real).all() and torch.isfinite(k.imag).all()
    assert float((k - p).abs().max()) <= 1e-3 * n_iter * float(mag.max())
    assert float(torch.linalg.norm(k - p) / torch.linalg.norm(p)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [1, 3, 94])
def test_kernel_ragged_blocks_off_the_tile_grid(card, n_iter):
    """t_pad 88 (no multiple of 64: blocks start inside row tiles) with
    ragged zero-magnitude pad frames: pad rows exactly zero, and the short
    loops against the plain version."""
    lengths = [88, 61, 75, 40, 83, 9, 88]
    S = ragged_batch(lengths, 88)
    mag = torch.from_numpy(np.abs(S).astype(np.float32)).to(card)
    init = torch.from_numpy(S).to(card)
    k = tgl.griffin_lim_phases(mag, CFG, n_iter=n_iter, init_spec=init)
    torch.cuda.synchronize()
    pad = torch.arange(88, device=card)[None, :] >= torch.tensor(lengths, device=card)[:, None]
    assert torch.isfinite(k.real).all() and torch.isfinite(k.imag).all()
    assert float((k.abs() * pad[:, None, :]).max()) == 0.0
    if n_iter <= 3:
        p = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=n_iter, init_spec=init)
        assert float((k - p).abs().max()) <= 1e-3 * n_iter * float(mag.max())
        assert float(torch.linalg.norm(k - p) / torch.linalg.norm(p)) <= 1e-3


@pytest.mark.cuda
def test_basis_images_follow_the_layout_model(card):
    """gl_tile_bases' two images against operand_offset, bit for bit, and
    the constants the CUDA file exports against the Python model's."""
    import ctypes

    c = tgl._device_consts(CFG.n_fft, CFG.win_length, CFG.hop_length, card)
    syn_b, ana_b = tgl._kernel_bases(CFG.n_fft, CFG.win_length, CFG.hop_length, card)
    cs = c.cs.cpu().view(torch.int16).numpy()
    for image, plain in ((syn_b, cs), (ana_b, cs.T)):
        rows, k = plain.shape
        off = tgl.operand_offset(np.arange(rows)[:, None], np.arange(k)[None, :], rows)
        want = np.empty(rows * k, np.int16)
        want[off.reshape(-1)] = plain.reshape(-1)
        assert np.array_equal(image.cpu().view(torch.int16).numpy().reshape(-1), want)
    out = (ctypes.c_int * 6)()
    tgl._gl_lib().gl_constants(out)
    assert list(out) == [tgl.IMAGE_K, tgl.NUM_SMS, tgl.PLAN_START, tgl.PLAN_EPI_SYN,
                         tgl.PLAN_EPI_ANA, tgl.PLAN_SPLIT]
    assert tgl._gl_lib().gl_tile_rows() == tgl.IMAGE_ROW_PAD
    for rows in (8, 344, 392, 768, 4096, 4104, 20000):
        assert tgl.kernel_plan(rows, c.f_pad, c.s_pad) == tgl.launch_plan(rows, c.f_pad, c.s_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [41, 500])  # one block; two 384-frame segments
def test_fused_vocoder_on_card_meets_sc_bound(card, n_frames):
    """The hybrid vocoder through the kernel converges as the JAX package
    requires of it: SC below the exact loop's + 0.05."""
    mag_np = np.abs(spec_frames(n_frames, seed=2)).astype(np.float32)
    mag = torch.from_numpy(mag_np).to(card)
    before = tgl.griffin_lim_phases.launches
    wav_k = griffin_lim(mag, CFG, method="fused").cpu().numpy()
    wav_x = griffin_lim(mag, CFG, method="exact").cpu().numpy()
    assert tgl.griffin_lim_phases.launches == before + 1
    assert wav_k.shape == wav_x.shape == (CFG.hop_length * (n_frames - 1),)
    assert np.isfinite(wav_k).all()
    assert sc(mag_np, wav_k) < sc(mag_np, wav_x) + 0.05


@pytest.mark.cuda
def test_kernel_rejects_a_hop_it_cannot_band(card):
    """gl_run refuses shapes its launches cannot take, and the wrapper
    raises instead of falling back."""
    cfg = SignalConfig(hop_length=302)  # the band pass needs hop % 4 == 0
    mag = torch.ones(1, 1 + cfg.n_fft // 2, 20, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        tgl.griffin_lim_phases(mag, cfg, n_iter=1)


@pytest.mark.cuda
def test_kernel_on_ragged_serving_batch(card):
    """Case c: 32 stacked blocks of t_pad 128 (4096 rows), zero past each
    block's own length. One seeded iteration against the plain version;
    pad rows exactly zero after 1 and after 94 iterations; the ragged fused
    vocoder launches the kernel once and meets the SC bound per block."""
    lengths = [n for n in (128, 120, 128, 104) for _ in range(8)]
    S = ragged_batch(lengths, 128)
    mag_np = np.abs(S).astype(np.float32)
    mag = torch.from_numpy(mag_np).to(card)
    init = torch.from_numpy(S).to(card)
    k = tgl.griffin_lim_phases(mag, CFG, n_iter=1, init_spec=init)
    p = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=1, init_spec=init)
    assert float((k - p).abs().max()) <= 1e-3 * float(mag.max())
    assert float(torch.linalg.norm(k - p) / torch.linalg.norm(p)) <= 1e-3
    k94 = tgl.griffin_lim_phases(mag, CFG, n_iter=94)
    torch.cuda.synchronize()
    pad = torch.arange(128, device=card)[None, :] >= torch.tensor(lengths, device=card)[:, None]
    for spec in (k, k94):
        assert torch.isfinite(spec.real).all() and torch.isfinite(spec.imag).all()
        assert float((spec.abs() * pad[:, None, :]).max()) == 0.0
    before = tgl.griffin_lim_phases.launches
    w_f = griffin_lim_masked(mag, lengths, CFG, method="fused").cpu().numpy()
    w_e = griffin_lim_masked(mag, lengths, CFG, method="exact").cpu().numpy()
    assert tgl.griffin_lim_phases.launches == before + 1
    assert np.isfinite(w_f).all()
    for i, n in enumerate(lengths):
        m, samples = mag_np[i][:, :n], CFG.hop_length * (n - 1)
        assert sc(m, w_f[i, :samples]) < sc(m, w_e[i, :samples]) + 0.05


@pytest.mark.cuda
def test_kernel_rejects_more_rows_than_it_can_index(card):
    """The kernels count state elements in an int: the wrapper raises on a
    row count past gl_max_rows before it allocates or launches anything."""
    lib = tgl._gl_lib()
    c = tgl._device_consts(CFG.n_fft, CFG.win_length, CFG.hop_length, card)
    max_rows = lib.gl_max_rows(c.f_pad, c.s_pad)
    assert max_rows == (2**31 - 1 - 256) // 1152
    blocks = max_rows // 128 + 1
    mag = torch.empty(blocks, 1 + CFG.n_fft // 2, 128, device=card)  # ~7.6 GB, never read
    before = tgl.griffin_lim_phases.launches
    with pytest.raises(ValueError, match="rows"):
        tgl.griffin_lim_phases(mag, CFG, n_iter=1)
    assert tgl.griffin_lim_phases.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("sn", [False, True])
def test_train_step_on_card_matches_cpu(card, sn):
    """One training step at a narrow width on the card against the same
    step on the CPU, through the comparison chip_smoke.py makes at full
    width, with its tolerances (losses rtol 1e-4, pre-clip grad_norm rtol
    1e-3, first moments within 1e-3 of their norm, updated parameters atol
    1e-5 wherever the gradient exceeds 1e-4 but for one entry in a million,
    and never further apart than 2 x lr, weight_u atol 1e-5)."""
    import importlib.util
    from pathlib import Path

    from adaptive_voice_conversion_tpu_torch.core import config as tcfg

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
    )
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = tcfg.TrainConfig(
        model=tcfg.AEConfig(
            speaker_encoder=tcfg.SpeakerEncoderConfig(
                c_in=16, c_h=16, c_out=8, bank_size=4, c_bank=8, n_conv_blocks=2,
                n_dense_blocks=1, subsample=(1, 2),
            ),
            content_encoder=tcfg.ContentEncoderConfig(
                c_in=16, c_h=16, c_out=8, bank_size=4, c_bank=8, n_conv_blocks=2,
                subsample=(1, 2),
            ),
            decoder=tcfg.DecoderConfig(
                c_in=8, c_cond=8, c_h=16, c_out=16, n_conv_blocks=2, upsample=(2, 1), sn=sn,
            ),
        ),
        data_loader=tcfg.DataLoaderConfig(segment_size=32, batch_size=8),
    )
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = smoke.train_step_card_vs_cpu(cfg, seed=3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert result["n_params"] > 0 and ("worst_u" in result) == sn
    rel = lambda k: abs(result["card"][k] - result["cpu"][k]) / abs(result["cpu"][k])
    assert max(rel(k) for k in ("loss", "loss_rec", "loss_kl")) <= smoke.TOL_STEP_LOSS
    assert rel("grad_norm") <= smoke.TOL_STEP_GRAD_NORM
    smoke.check_step_parity(result, f"sn={sn}")  # exits on a failure
    assert result["clear_beyond"] <= smoke.TOL_STEP_CLEAR_SHARE
    assert result["worst_param"] <= 2 * cfg.optimizer.lr + smoke.TOL_STEP_PARAM
    assert result["moment_all"] <= smoke.TOL_STEP_MOMENT
    if sn:
        assert result["worst_u"] <= smoke.TOL_STEP_U
