"""The port's MFCC frontend (var_tpu_torch.ops.audio, ops.mel_log_dct)
against the JAX package on the same numpy-seeded inputs.

Tolerance rtol = atol = 1e-4 (the frontend's contract, BASELINE.md): both
sides compute in IEEE float32 from the same float64-built constants, and
only the order of summation differs. The NSynth golden vectors keep the
2e-3 absolute tolerance of tests/test_audio_golden_npz.py, whose reason
holds for any float32 implementation: the 1024-point window accumulates
more error ahead of the log.

On the CPU, mel_log_dct takes its plain version; the kernel itself is
compared with it on the card by chip_smoke.py and by the `cuda`-marked
tests of tests/test_torch_kernels.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.ops import audio as jaudio
from var_tpu.ops.audio_pallas import mel_log_dct_pallas
from var_tpu_torch.ops import audio
from var_tpu_torch.ops import mel_log_dct as mld

TOL = dict(rtol=1e-4, atol=1e-4)
PRESETS = ["GoogleCommand", "NSynth"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "audio_mfcc.npz")


def _power(preset, B=3, frames=20, seed=0):
    """A power spectrogram from the JAX gemm STFT of seeded waveforms,
    with one all-zero frame row (a masked frame: log(1e-6))."""
    params = jaudio.PARAM_TABLE[preset]
    rng = np.random.RandomState(seed)
    wav = (rng.randn(B, frames * params.hop_length) * 0.2).astype(np.float32)
    power = np.array(jaudio._stft_power_gemm(jnp.asarray(wav), params))
    power[0, -2:] = 0.0
    return params, power


@pytest.mark.parametrize("preset", PRESETS)
def test_mel_log_dct_reference_matches_pallas_kernel(preset):
    params, power = _power(preset)
    want = np.asarray(mel_log_dct_pallas(jnp.asarray(power), params))
    got = mld.mel_log_dct_reference(torch.from_numpy(power), params).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("preset", PRESETS)
def test_mel_log_dct_matches_mfcc_from_power(preset):
    params, power = _power(preset, seed=1)
    want = np.asarray(jaudio.mfcc_from_power(jnp.asarray(power), params))
    got = mld.mel_log_dct(torch.from_numpy(power), params).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        audio.mfcc_from_power(torch.from_numpy(power), params).numpy(),
        want, **TOL)


def test_cpu_tensor_takes_plain_path_without_launch():
    params, power = _power("GoogleCommand", seed=2)
    before = mld.mel_log_dct.launches
    out = mld.mel_log_dct(torch.from_numpy(power), params)
    assert mld.mel_log_dct.launches == before == 0
    assert out.shape == power.shape[:2] + (40,)


@pytest.mark.parametrize("bad", ["dtype", "rank", "bins", "strided", "grad"])
def test_mel_log_dct_rejects_what_the_kernel_does_not_take(bad):
    params, power = _power("GoogleCommand", seed=3)
    p = torch.from_numpy(power)
    if bad == "dtype":
        p, err = p.double(), TypeError
    elif bad == "rank":
        p, err = p[0], ValueError
    elif bad == "bins":
        p, err = p[..., :-1].contiguous(), ValueError
    elif bad == "strided":
        p, err = p.transpose(0, 1), ValueError
    else:
        p, err = p.requires_grad_(), RuntimeError
    with pytest.raises(err):
        mld.mel_log_dct(p, params)


def _layout(power: np.ndarray, layout: str) -> torch.Tensor:
    """(B, T, F) numpy power as the kernel takes it: contiguous, or the
    gemm STFT's view of a contiguous (B, F, T) tensor."""
    if layout == "contiguous":
        return torch.from_numpy(np.ascontiguousarray(power))
    return torch.from_numpy(
        np.ascontiguousarray(power.transpose(0, 2, 1))).transpose(1, 2)


def _banded_model(power: torch.Tensor, params) -> np.ndarray:
    """numpy model of the kernel's arithmetic, reading the tensor's storage
    with the kernel's addressing: the padded spans of kernel_table summed
    in float32, a row flagged when a span sum or a hole is non-finite, the
    log, then the DCT from dct_half's 20 terms x[n] +- x[39 - n]."""
    B, T, F = power.shape
    freq_major = mld._freq_major(power)
    store = (power.transpose(1, 2) if freq_major else power
             ).contiguous().numpy().ravel()
    b, t = np.meshgrid(np.arange(B), np.arange(T), indexing="ij")

    def bin_values(f):  # (B, T)
        return store[b * F * T + f * T + t] if freq_major \
            else store[(b * T + t) * F + f]

    _, _, mel, dct, _, _ = audio._frontend_constants(params, "float32")
    table, weights = mld.kernel_table(mel)
    rows, holes = table[:160].reshape(40, 4), table[160:]
    half = mld.dct_half(dct)
    warps, _, per_warp = half.shape
    sums = np.zeros((B, T, 40), np.float32)
    bad = np.zeros((B, T), bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for m, lo, length, off in rows:
            acc = np.zeros((B, T), np.float32)
            for k in range(length):
                acc += bin_values(lo + k) * weights[off + k]
            sums[..., m] = acc
            bad |= ~np.isfinite(acc)
        for h in holes:
            bad |= ~np.isfinite(bin_values(h))
        lmel = np.log(sums + np.float32(audio.LOG_EPS))
        lmel[bad] = np.nan
        out = np.empty((B, T, 40), np.float32)
        for w in range(warps):
            v = lmel[..., :20] + (-1) ** w * lmel[..., 39 - np.arange(20)]
            for j in range(per_warp):
                out[..., w + warps * j] = v @ half[w, :, j]
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_band_tables_rebuild_the_filterbank_bit_for_bit(preset):
    params = jaudio.PARAM_TABLE[preset]
    mel = audio._frontend_constants(params, "float32")[2]
    lo, length, offset, weights = mld.band_table(mel)
    dense = np.zeros_like(mel)
    for m in range(40):
        dense[lo[m]: lo[m] + length[m], m] = \
            weights[offset[m]: offset[m] + length[m]]
    np.testing.assert_array_equal(dense, mel)
    assert weights.size == np.count_nonzero(mel) == {257: 494, 513: 988}[
        mel.shape[0]]

    table, padded = mld.kernel_table(mel)
    rows, holes = table[:160].reshape(40, 4), table[160:]
    assert sorted(rows[:, 0]) == list(range(40))
    assert (rows[:, 2] % 4 == 0).all() and (rows[:, 3] % 4 == 0).all()
    dense = np.zeros_like(mel)
    covered = np.zeros(mel.shape[0], bool)
    for m, start, n, off in rows:
        assert 0 <= start and start + n <= mel.shape[0]
        dense[start: start + n, m] = padded[off: off + n]
        covered[start: start + n] = True
    np.testing.assert_array_equal(dense, mel)
    np.testing.assert_array_equal(holes, np.flatnonzero(~covered))
    loads = rows[:, 2].reshape(mld.KERNEL_WARPS, -1).sum(1)
    assert loads.max() - loads.min() <= 8  # dealt longest first


def test_band_tables_raise_for_an_empty_filter():
    mel = audio._frontend_constants(jaudio.PARAM_TABLE["GoogleCommand"],
                                    "float32")[2].copy()
    mel[:, 7] = 0.0
    with pytest.raises(ValueError, match="filter 7"):
        mld.band_table(mel)
    with pytest.raises(ValueError, match="filter 7"):
        mld.kernel_table(mel)


def test_dct_half_is_the_dct_and_rejects_other_matrices():
    dct = audio._frontend_constants(jaudio.PARAM_TABLE["GoogleCommand"],
                                    "float32")[3]
    half = mld.dct_half(dct)
    assert half.shape == (mld.KERNEL_WARPS, 20, 40 // mld.KERNEL_WARPS)
    for w in range(mld.KERNEL_WARPS):
        np.testing.assert_array_equal(half[w], dct[:20, w::mld.KERNEL_WARPS])
    with pytest.raises(ValueError, match="DCT-II"):
        mld.dct_half(np.random.RandomState(0).rand(40, 40))


@pytest.mark.parametrize("layout", ["contiguous", "stft view"])
@pytest.mark.parametrize("preset", PRESETS)
def test_banded_model_matches_dense_and_pallas_kernel(preset, layout):
    params, power = _power(preset, seed=7)
    p = _layout(power, layout)
    assert mld._freq_major(p) == (layout == "stft view")
    got = _banded_model(p, params)
    np.testing.assert_allclose(
        got, mld.mel_log_dct_reference(p, params).numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(mel_log_dct_pallas(jnp.asarray(power), params)), **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "stft view"])
def test_banded_model_and_plain_version_turn_non_finite_rows_nan(layout):
    params, power = _power("GoogleCommand", seed=8)
    power[0, 1, 17] = np.nan
    power[0, 2, 0] = np.inf  # bin 0 lies in no band: a hole
    power[1, 3, 100] = np.inf
    power[2, 4, 256] = -np.inf
    p = _layout(power, layout)
    want = mld.mel_log_dct_reference(p, params).numpy()
    bad = np.zeros(power.shape[:2], bool)
    bad[0, 1] = bad[0, 2] = bad[1, 3] = bad[2, 4] = True
    assert np.isnan(want[bad]).all() and np.isfinite(want[~bad]).all()
    np.testing.assert_allclose(_banded_model(p, params), want, equal_nan=True,
                               **TOL)


def test_wrapper_takes_the_stft_view_as_it_lies():
    params = jaudio.PARAM_TABLE["GoogleCommand"]
    wav = torch.from_numpy((np.random.RandomState(9).randn(
        2, 10 * params.hop_length + params.n_fft) * 0.2).astype(np.float32))
    view = audio._stft_power_gemm(wav, params, pre_padded=True)
    assert view.stride() == (view.shape[1] * view.shape[2], 1, view.shape[1])
    torch.testing.assert_close(
        mld.mel_log_dct(view, params),
        mld.mel_log_dct_reference(view.contiguous(), params), **TOL)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("pre_padded", [False, True])
@pytest.mark.parametrize("backend", ["fft", "gemm", "pallas"])
def test_mfcc_batch_matches_jax(backend, pre_padded, preset):
    params = jaudio.PARAM_TABLE[preset]
    rng = np.random.RandomState(4)
    wav = (rng.randn(2, 12 * params.hop_length + params.n_fft) * 0.3
           ).astype(np.float32)
    want = np.asarray(jaudio.mfcc_batch(jnp.asarray(wav), params,
                                        backend=backend,
                                        pre_padded=pre_padded))
    got = audio.mfcc_batch(torch.from_numpy(wav), params, backend=backend,
                           pre_padded=pre_padded).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["fft", "gemm", "pallas"])
def test_sound_features_matches_jax(backend):
    """int16 pack_waveform rows of mixed lengths, a truncated clip, the
    frame mask and zero_mask rows."""
    params = jaudio.PARAM_TABLE["GoogleCommand"]
    target = 30
    buf_len = target * params.hop_length + params.n_fft
    rng = np.random.RandomState(5)
    lengths = [1200, 3000, 4800, 9000]  # the last exceeds target frames
    rows, lens = [], []
    for n in lengths:
        clip = (rng.randn(n) * 6000).astype(np.int16)
        clip = clip[: buf_len - params.n_fft]
        rows.append(jaudio.pack_waveform(clip, buf_len, params.n_fft,
                                         keep_int16=True))
        lens.append(len(clip))
    wav = np.stack(rows)
    lens = np.asarray(lens, np.int32)
    zero = np.array([False, True, False, False])
    for target_frames in (target, target + 7):  # truncate and pad
        want = np.asarray(jaudio.sound_features(
            jnp.asarray(wav), jnp.asarray(lens), target_frames, params,
            backend=backend, zero_mask=jnp.asarray(zero)))
        got = audio.sound_features(
            torch.from_numpy(wav), torch.from_numpy(lens), target_frames,
            params, backend=backend, zero_mask=torch.from_numpy(zero)).numpy()
        assert got.shape == want.shape == (4, 1, target_frames, 40)
        np.testing.assert_allclose(got, want, **TOL)
        assert not got[1].any()


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("backend", ["fft", "gemm", "pallas"])
def test_mfcc_batch_matches_golden(backend, preset):
    data = np.load(GOLDEN)
    params = audio.PARAM_TABLE[preset]
    atol = 1e-4 if preset == "GoogleCommand" else 2e-3
    names = sorted(k[len("wav_"):] for k in data.files if k.startswith("wav_"))
    checked = 0
    for name in names:
        if f"mfcc_{preset}_{name}" not in data:
            continue  # sub-n_fft clip skipped for this preset
        wav = (data[f"wav_{name}"] / 32768.0).astype(np.float32)
        got = audio.mfcc_batch(torch.from_numpy(wav)[None], params,
                               backend=backend)[0].numpy()
        np.testing.assert_allclose(got, data[f"mfcc_{preset}_{name}"],
                                   rtol=1e-4, atol=atol, err_msg=name)
        checked += 1
    assert checked > 0


def test_mfcc_single_numpy_matches_jax_and_golden():
    data = np.load(GOLDEN)
    params = audio.PARAM_TABLE["GoogleCommand"]
    for k in data.files:
        if not k.startswith("wav_"):
            continue
        name = k[len("wav_"):]
        got = audio.mfcc_single(data[k], params)
        np.testing.assert_array_equal(got, jaudio.mfcc_single(data[k], params))
        if f"mfcc_GoogleCommand_{name}" in data:
            np.testing.assert_allclose(
                got, data[f"mfcc_GoogleCommand_{name}"], **TOL)


@pytest.mark.parametrize("preset", sorted(jaudio.PARAM_TABLE))
def test_numpy_constants_are_the_reference_copy(preset):
    params = audio.PARAM_TABLE[preset]
    assert params == jaudio.PARAM_TABLE[preset]
    for ours, ref in zip(audio._frontend_constants(params, "float32"),
                         jaudio._frontend_constants(params, "float32")):
        np.testing.assert_array_equal(ours, ref)
    clip = np.random.RandomState(6).randint(-3000, 3000, 5000).astype(np.int16)
    np.testing.assert_array_equal(
        audio.pack_waveform(clip, 8000, params.n_fft, keep_int16=True),
        jaudio.pack_waveform(clip, 8000, params.n_fft, keep_int16=True))

