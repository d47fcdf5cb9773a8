"""The fused Griffin-Lim kernel's plain version and the hybrid schedule
(adaptive_voice_conversion_tpu_torch.kernels.griffin_lim) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Tolerances, and why they differ by iteration count:
- one iteration seeded with the signal's own STFT phases: every bin
  within a bound computed from the inputs (``flip_bound``: what any f32
  summation order can change, through the bf16 rounding of the synthesis
  frames, the analysis product and the projection), and a relative
  Frobenius error <= 1e-4 over all bins. Only the f32 summation order
  differs, plus the bf16 rounding flips it can cause at the kernel's two
  rounding points; where |X2| is rounding noise the projection can turn a
  bin by any angle, and the bound there is twice the bin's magnitude.
- five iterations from zero phase: relative Frobenius error <= 1e-2. From
  zero phase the first projections divide by |X2|, which nearly vanishes at
  some bins where the magnitude is large, so a last-bit difference in the
  f32 sums, or one bf16 flip of an operand, turns such a bin's phase by a
  visible angle; later iterations carry the difference on, so the bound
  grows with the count.
- the hybrid vocoder: SC within 0.01 of the JAX hybrid, and SC below the
  exact path's + 0.05 (tests/test_kernels.py).
The CUDA kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
(marked ``cuda``, no JAX) and chip_smoke.py hold it against the plain
version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptive_voice_conversion_tpu.core.config import SignalConfig as JSignal
from adaptive_voice_conversion_tpu.dsp.stft import stft_np
from adaptive_voice_conversion_tpu.dsp.vocoder import griffin_lim_jax
from adaptive_voice_conversion_tpu.kernels import griffin_lim as jgl
from adaptive_voice_conversion_tpu_torch.core.config import SignalConfig
from adaptive_voice_conversion_tpu_torch.dsp.vocoder import griffin_lim
from adaptive_voice_conversion_tpu_torch.kernels import griffin_lim as tgl

CFG, JCFG = SignalConfig(), JSignal()


def spec_of(seconds, seed=0, f0=220.0, n_samples=None):
    rng = np.random.default_rng(seed)
    n = int(round(seconds * CFG.sr)) if n_samples is None else n_samples
    t = np.arange(n) / CFG.sr
    y = (
        0.5 * np.sin(2 * np.pi * f0 * t)
        + 0.3 * np.sin(2 * np.pi * 2 * f0 * t) * np.exp(-2 * t)
        + 0.05 * rng.standard_normal(len(t))
    ).astype(np.float32)
    return stft_np(y, CFG.n_fft, CFG.hop_length, CFG.win_length)


def spec_frames(n_frames, seed=0):
    spec = spec_of(0.0, seed, n_samples=CFG.hop_length * (n_frames - 1))
    assert spec.shape[1] == n_frames
    return spec


def sc(mag, wav):
    est = np.abs(stft_np(np.asarray(wav), CFG.n_fft, CFG.hop_length, CFG.win_length))
    f = min(est.shape[1], mag.shape[1])
    return float(np.linalg.norm(est[:, :f] - mag[:, :f]) / np.linalg.norm(mag[:, :f]))


def test_constants_and_segments_match_jax():
    ours = tgl._gl_constants(CFG.n_fft, CFG.win_length, CFG.hop_length)
    ref = jgl._gl_constants(JCFG.n_fft, JCFG.win_length, JCFG.hop_length)
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert ours[4:] == ref[4:] and ours[5] == 4
    assert (tgl.SEG_FRAMES, tgl.SEG_OVERLAP) == (jgl.SEG_FRAMES, jgl.SEG_OVERLAP)
    for t in (10, 384, 385, 500, 737, 768, 2000):
        assert tgl._segment_starts(t) == jgl._segment_starts(t)


U32 = 2.0**-24  # unit roundoff of f32


def bf16_round(x):
    """f64 values rounded to bf16 (8 significant bits, to nearest even)."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0), e - 8)


def flip_bound(mag, spec):
    """Per-bin bound (B, n_freq, T) on |plain - pallas| after one iteration
    from ``spec``, valid for any f32 summation order of either side.

    The operands of the synthesis product are the same bf16 values on both
    sides, so the f64 product of them is exact; under any order an f32 sum of
    n terms lies within gamma_n * sum|terms| of it (gamma_n = n u / (1 - n u),
    u = 2^-24, with n the 2 * 1152 terms of a product, then the 2 * n_taps + 1
    of the band, then the gain's rounding). A synthesis sample is *marked*
    when that interval holds a bf16 rounding midpoint: the two sides may then
    round it to values hi - lo apart (one bf16 ulp, as a rule), and an
    unmarked one rounds the same on both. A bin of [re2 | im2] then moves by
    at most the marked samples of its frame times the basis magnitudes, plus
    both sides' f32 error in the analysis product; the projection
    mag * X2 / |X2| turns by at most 2 |dX2| / (|X2| - |dX2|), never more
    than 2, plus its own rounding. Returns (bound, marked samples, bins held
    below 2 * mag)."""
    gamma = lambda n: n * U32 / (1 - n * U32)
    c = tgl._device_consts(CFG.n_fft, CFG.win_length, CFG.hop_length, torch.device("cpu"))
    m, re, im, t_pad = tgl._to_frames(torch.from_numpy(mag), torch.from_numpy(spec), c.f_pad)
    a = torch.cat([re * c.ck, im * c.ck], 1).to(torch.bfloat16).double().numpy()
    cs, g, f_pad = c.cs.double().numpy(), c.g.double().numpy(), c.f_pad
    band = lambda x: tgl._band(torch.from_numpy(x), t_pad, CFG.hop_length, c.n_taps).numpy()
    syn = a @ cs.T
    e_syn = gamma(a.shape[1]) * (np.abs(a) @ np.abs(cs).T)
    acc = band(syn)
    e_acc = band(e_syn) + gamma(2 * c.n_taps + 1) * band(np.abs(syn) + e_syn)
    v = acc * g
    e_v = e_acc * g + U32 * (np.abs(v) + e_acc * g)
    lo, hi = bf16_round(v - e_v), bf16_round(v + e_v)
    x2 = bf16_round(v) @ cs
    e_ana = gamma(cs.shape[0]) * (np.maximum(np.abs(lo), np.abs(hi)) @ np.abs(cs))
    d = (hi - lo) @ np.abs(cs) + 2 * e_ana
    d = np.hypot(d[:, :f_pad], d[:, f_pad:])
    x2 = np.hypot(x2[:, :f_pad], x2[:, f_pad:])
    m = m.double().numpy()
    turn = np.minimum(2.0, 2 * d / np.maximum(x2 - d, 1e-300))
    bound = m * turn + 8 * U32 * m + 1e-30
    b, n_freq, t = mag.shape
    bound = bound.reshape(b, t_pad, f_pad).transpose(0, 2, 1)[:, :n_freq, :t]
    held = int((turn.reshape(b, t_pad, f_pad)[:, :t, :n_freq] < 2.0).sum())
    return bound, f"{int((lo != hi).sum())} of {lo.size}", held


@pytest.mark.parametrize("seconds", [0.5, 1.2])
def test_plain_one_iteration_matches_pallas(seconds):
    S = spec_of(seconds)[None]
    mag = np.abs(S).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim_phases_pallas(
        jnp.asarray(mag), JCFG, n_iter=1, interpret=True, init_spec=jnp.asarray(S)
    ))
    ours = tgl.griffin_lim_phases_plain(
        torch.from_numpy(mag), CFG, n_iter=1, init_spec=torch.from_numpy(S)
    ).numpy()
    assert ours.shape == ref.shape
    # The products' inputs are rounded to bf16, so a change of f32
    # summation order (another host's BLAS or XLA kernels) can flip the
    # rounding of a synthesis sample. The per-bin bound is computed from
    # these inputs (flip_bound) and holds under any order, so it does not
    # depend on the host. The relative Frobenius error holds every bin
    # together (measured 1.5e-7 at 0.5 s, 2.2e-5 at 1.2 s). A failure says
    # both, with the marked samples and the bins the bound holds.
    bound, marked, held = flip_bound(mag, S)
    diff = np.abs(ours.astype(np.complex128) - ref)
    ratio = diff / bound
    worst = np.unravel_index(np.argmax(ratio), ref.shape)
    fro = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    said = (f"max |diff| / bound {ratio.max():.3e} at (utt, bin, frame) {worst} "
            f"(|diff| {diff[worst]:.3e}, bound {bound[worst]:.3e}, |mag| {mag[worst]:.3e}, "
            f"max|mag| {mag.max():.3e}); {marked} synthesis samples marked; {held} of "
            f"{mag.size} bins held below 2|mag|; relative Frobenius {fro:.3e}; "
            f"{torch.get_num_threads()} torch threads")
    assert ratio.max() <= 1.0, said
    assert fro <= 1e-4, said


def test_plain_five_iterations_match_pallas_stacked():
    """Two utterances of different lengths padded to one T: JAX runs one
    grid program per utterance, the port stacks them along the rows, so
    this also holds the band's block mask against the grid boundary."""
    mags = np.stack([
        np.abs(spec_frames(61, seed=0)), np.abs(spec_frames(61, seed=1)) * 0.5
    ]).astype(np.float32)
    mags[1, :, 50:] = 0.0  # a shorter second utterance
    ref = np.asarray(jgl.griffin_lim_phases_pallas(jnp.asarray(mags), JCFG, n_iter=5, interpret=True))
    ours = tgl.griffin_lim_phases_plain(torch.from_numpy(mags), CFG, n_iter=5).numpy()
    for b in range(2):
        err = np.linalg.norm(ours[b] - ref[b]) / np.linalg.norm(ref[b])
        assert err <= 1e-2, (b, err)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    mag = torch.from_numpy(np.abs(spec_frames(20))[None].astype(np.float32))
    before = tgl.griffin_lim_phases.launches
    a = tgl.griffin_lim_phases(mag, CFG, n_iter=2)
    b = tgl.griffin_lim_phases_plain(mag, CFG, n_iter=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tgl.griffin_lim_phases.launches == before
    # zero iterations return the seed spectrum unchanged
    init = torch.from_numpy(spec_frames(20)[None])
    torch.testing.assert_close(tgl.griffin_lim_phases(mag, CFG, 0, init), init)


@pytest.mark.parametrize(
    "n_frames,n_iter,kw",
    [
        (57, 30, {}),
        (424, 8, {}),  # > 384 frames: two stacked segments, stitched
        (57, 12, dict(warm_start=2, polish_iters=2, ext_frames=4)),
        (57, 12, dict(warm_start=0, polish_iters=3, schedule="interleaved")),
        (57, 12, dict(warm_start=0, polish_iters=0, ext_frames=0)),
    ],
)
def test_fused_hybrid_matches_pallas_hybrid(n_frames, n_iter, kw):
    mag = np.abs(spec_frames(n_frames)).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim_pallas(jnp.asarray(mag), JCFG, n_iter=n_iter, interpret=True, **kw))
    ours = tgl.griffin_lim_fused(torch.from_numpy(mag), CFG, n_iter=n_iter, **kw).numpy()
    assert ours.shape == ref.shape == (CFG.hop_length * (n_frames - 1),)
    assert np.isfinite(ours).all()
    sc_t, sc_j = sc(mag, ours), sc(mag, ref)
    assert abs(sc_t - sc_j) < 0.01, (sc_t, sc_j)
    sc_x = sc(mag, griffin_lim_jax(jnp.asarray(mag), JCFG, n_iter=n_iter))
    assert sc_t < sc_x + 0.05, (sc_t, sc_x)


def test_device_basis_is_the_plain_cs():
    """The wrapper hands the kernel the basis untiled: cs (s_pad, 2*f_pad)
    is [w*cos | -w*sin] of the constants rounded once to bf16, ck and g are
    the f32 constants, and every padded frequency column is zero (the
    kernel's tiling of cs lives in csrc/griffin_lim.cu alone)."""
    cos_m, sin_m, ck, g, _, n_taps = tgl._gl_constants(CFG.n_fft, CFG.win_length, CFG.hop_length)
    c = tgl._device_consts(CFG.n_fft, CFG.win_length, CFG.hop_length, torch.device("cpu"))
    assert (c.s_pad, c.f_pad, c.n_taps) == (1280, 1152, n_taps) and c.cs.dtype == torch.bfloat16
    want = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)).to(torch.bfloat16)
    assert torch.equal(c.cs, want)
    assert torch.equal(c.ck, torch.from_numpy(ck)) and torch.equal(c.g, torch.from_numpy(g))
    n_freq = 1 + CFG.n_fft // 2
    for half in (0, c.f_pad):
        assert not c.cs[:, half + n_freq : half + c.f_pad].any()
    assert not c.ck[n_freq:].any()


def test_fused_batched_rows_identical():
    mag = np.abs(spec_frames(40)).astype(np.float32)
    w = griffin_lim(torch.from_numpy(np.stack([mag, mag])), CFG, n_iter=6, method="fused")
    torch.testing.assert_close(w[0], w[1], rtol=0, atol=1e-6)


# --- the Python models of the CUDA file's operand layout and launch plan ---

F_PAD, S_PAD = 1152, 1280
# the design before the redesign, by its code: two (M, S) f32 partial sums
# at every row count, and re/im f32 stored by every iteration
OLD_SYN_SCRATCH = lambda rows: 2 * rows * S_PAD * 4
OLD_ITERATION_BYTES = lambda rows: (
    2 * (2 * rows * S_PAD * 4)  # partial sums written, then read by the band
    + 2 * rows * F_PAD * 4  # re and im f32 stored
    + 2 * (rows * 2 * F_PAD * 2 + rows * S_PAD * 2)  # a_syn and a_ana written and read
    + rows * F_PAD * 4  # mag read
    + 2 * S_PAD * 2 * F_PAD * 2  # the two basis operands read
)


@pytest.mark.parametrize("rows", [344, 384, 4096])
@pytest.mark.parametrize("k_cols", [S_PAD, 2 * F_PAD])
def test_operand_offset_is_a_bijection_that_keeps_16_byte_pieces(rows, k_cols):
    """An A operand image at a row count of the one-shot path (344), of a
    full segment (384) and of the serving grid (4096), for both products'
    K: every element has its own place inside the image, and the 8 elements
    of a 16-byte piece stay adjacent, in order, on a 16-byte boundary."""
    pad = -(-rows // tgl.IMAGE_ROW_PAD) * tgl.IMAGE_ROW_PAD
    off = tgl.operand_offset(np.arange(pad)[:, None], np.arange(k_cols)[None, :], pad)
    flat = np.sort(off.reshape(-1))
    assert flat[0] == 0 and flat[-1] == pad * k_cols - 1 and (np.diff(flat) == 1).all()
    pieces = off.reshape(pad, k_cols // 8, 8)
    assert (pieces[:, :, 0] % 8 == 0).all()
    assert (pieces == pieces[:, :, :1] + np.arange(8)).all()
    # a run of rows of one k tile is one contiguous block: what a bulk copy takes
    tile = off[8:24, 64:128]
    assert tile.min() == off[8, 64] - (off[8, 64] % 64) and tile.max() - tile.min() == 16 * 64 - 1


def test_operand_offset_swizzles_pieces_by_row():
    """Row r keeps its 128 bytes of a k tile together and stores piece p at
    p ^ (r % 8), the tensor cores' 128-byte swizzle."""
    rows = 256
    for r in (0, 1, 7, 8, 13, 255):
        for k in (0, 8, 56, 64, 72, 2296):
            base = ((k // 64) * rows + r) * 64
            piece = ((k % 64) // 8) ^ (r % 8)
            assert tgl.operand_offset(r, k, rows) == base + 8 * piece
            assert tgl.operand_offset(r, k + 5, rows) == base + 8 * piece + 5


@pytest.mark.parametrize(
    "rows,plan",
    [
        (344, tgl.LaunchPlan(128, 128, 4, 64, 128)),  # one shot: 120 and 108 blocks
        (4096, tgl.LaunchPlan(256, 160, 1, 256, 144)),  # serving grid: 128 and 256 blocks
    ],
)
def test_launch_plan_at_the_two_measured_shapes(rows, plan):
    assert tgl.launch_plan(rows) == plan


@pytest.mark.parametrize("rows", [8, 136, 208, 344, 392, 768, 1032, 2048, 4096, 4104, 20000])
def test_launch_plan_is_launchable(rows):
    """Every plan names tiles the CUDA file instantiates, that divide the
    widths; K is split only where the tiles alone leave SMs idle, and then
    the split grid still fits the SMs in one round."""
    p = tgl.launch_plan(rows)
    assert (p.syn_bm, p.syn_bn) in tgl._SYN_TILES and (p.ana_bm, p.ana_bn) in tgl._ANA_TILES
    assert S_PAD % p.syn_bn == 0 and F_PAD % (p.ana_bn // 2) == 0
    assert (2 * F_PAD // tgl.IMAGE_K) % p.syn_split == 0
    tiles = -(-rows // p.syn_bm) * (S_PAD // p.syn_bn)
    if p.syn_split > 1:
        assert tiles < tgl.NUM_SMS and tiles * p.syn_split <= tgl.NUM_SMS
    if tiles >= tgl.NUM_SMS:
        assert p.syn_split == 1


def test_serving_shape_moves_fewer_bytes_than_the_old_design():
    rows = 4096
    plan = tgl.launch_plan(rows)
    scratch = tgl.scratch_bytes(rows, plan)
    assert plan.syn_split == 1
    assert scratch["syn"] == rows * S_PAD * 4 <= 21e6 < OLD_SYN_SCRATCH(rows) == 41943040
    it = tgl.iteration_bytes(rows, plan)
    last = tgl.iteration_bytes(rows, plan, last=True)
    assert it["total"] < 0.65 * OLD_ITERATION_BYTES(rows)
    # re and im are stored once per call, by the last iteration alone
    assert last["total"] - it["total"] == 2 * rows * F_PAD * 4
    assert last["ana_gemm_write"] - it["ana_gemm_write"] == 2 * rows * F_PAD * 4
    per_call = 93 * it["total"] + last["total"]
    assert per_call < 94 * OLD_ITERATION_BYTES(rows) - 93 * 2 * rows * F_PAD * 4


def test_one_shot_shape_scratch_and_bytes():
    rows = 344
    plan = tgl.launch_plan(rows)
    scratch = tgl.scratch_bytes(rows, plan)
    # the operand images are padded to whole row tiles; the partial sums are not
    assert scratch["a_syn"] == 512 * 2 * F_PAD * 2 and scratch["a_ana"] == 512 * S_PAD * 2
    assert scratch["syn"] == plan.syn_split * rows * S_PAD * 4
    it = tgl.iteration_bytes(rows, plan)
    assert it["band_read"] == scratch["syn"] + S_PAD * 4
    assert it["total"] == sum(v for k, v in it.items() if k != "total")
