"""MFCC audio frontend in PyTorch (port of var_tpu/ops/audio.py).

Numerical contract (torchaudio.transforms.MFCC with log_mels=True,
n_mfcc=40, n_mels=40, f_min=0, f_max=None, window_fn=torch.hamming_window,
within 1e-4):

  wav (int16/32768 float)  ->  STFT power spectrum
      center=True, reflect padding of n_fft//2, hop = windowStepTime*fs,
      win_length = windowLenTime*fs, hamming window (periodic),
      window zero-padded symmetrically to n_fft
  ->  mel filterbank (HTK scale, norm=None, triangular, n_mels=40)
  ->  log(mel + 1e-6)
  ->  DCT-II, 'ortho' norm, n_mfcc=40
  ->  pad-or-truncate frames to sound_dim[1], leading channel dim.

The numpy half (constants, packing, the host single-clip MFCC) is a copy of
the JAX package's. The batched device half has three backends, selected by
the `audioBackend` knob with the same names as in the JAX package:

* 'fft'    torch.fft.rfft over explicitly framed windows;
* 'gemm'   window and DFT folded into one strided conv1d over the waveform;
* 'pallas' the gemm power spectrum, then mel -> log -> DCT in the
  hand-written CUDA kernel of ops/mel_log_dct.py (the name is kept so that
  config files mean the same in both packages).

Variable-length clips use fixed buffers plus an integer sample length;
frames beyond 1 + len//hop are zeroed, and `zero_mask` rows (the "empty
intent" class) give an all-zero feature.

`mfcc_psf` is the other semantics the JAX package offers on the host
(`get_mfcc(mfcc_from=...)`): python_speech_features' mfcc, in numpy
float64.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class STFTParams(NamedTuple):
    """Per-dataset STFT parameters (reference: Envs/audioLoader.py:23-31)."""

    n_fft: int
    win_length: int
    hop_length: int
    sample_rate: int = 16000


# reference: Envs/audioLoader.py:23-31 (times converted at fs=16 kHz)
PARAM_TABLE = {
    "GoogleCommand": STFTParams(512, 400, 160),
    "NSynth": STFTParams(1024, 800, 640),
    "UrbanSound": STFTParams(1024, 800, 640),
    "ESC50": STFTParams(512, 400, 160),
    "FSC": STFTParams(512, 400, 160),
    "Spatial": STFTParams(512, 400, 160),
    "Synthetic": STFTParams(512, 400, 160),
}

N_MFCC = 40
N_MELS = 40
LOG_EPS = 1e-6


def hamming_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """torch.hamming_window(win_length) — periodic, alpha=0.54 beta=0.46."""
    n = np.arange(win_length, dtype=dtype)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max=None
) -> np.ndarray:
    """Triangular mel filterbank, HTK scale, norm=None; (n_freqs, n_mels)."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """DCT-II basis with 'ortho' norm; returns (n_mels, n_mfcc)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    dct[0] *= 1.0 / np.sqrt(2.0)
    dct *= np.sqrt(2.0 / n_mels)
    return dct.T


@functools.lru_cache(maxsize=None)
def _frontend_constants(params: STFTParams, dtype_name: str):
    """Window-folded DFT, mel and DCT matrices (host, built in float64)."""
    n_fft, win, _, sr = params
    dtype = np.dtype(dtype_name)
    ham = hamming_window(win)
    # torch.stft zero-pads the window symmetrically to n_fft; the frame
    # slice that actually contributes starts `off` samples into each
    # n_fft-long centered frame.
    off = (n_fft - win) // 2
    n = np.arange(win, dtype=np.float64) + off
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft  # (win, n_freqs)
    w_cos = (ham[:, None] * np.cos(phase)).astype(dtype)
    w_sin = (ham[:, None] * -np.sin(phase)).astype(dtype)
    mel = mel_filterbank(n_fft // 2 + 1, N_MELS, sr).astype(dtype)
    dct = dct_matrix(N_MFCC, N_MELS).astype(dtype)
    ham_padded = np.zeros(n_fft, dtype=dtype)
    ham_padded[off : off + win] = ham
    return w_cos, w_sin, mel, dct, ham_padded, off


@functools.lru_cache(maxsize=16)
def torch_constants(params: STFTParams, device: torch.device):
    """The float32 frontend constants as tensors on `device`, built once per
    (params, device): (dft conv weight (2F, 1, win), mel (F, 40),
    dct (40, 40), padded hamming window (n_fft,))."""
    w_cos, w_sin, mel, dct, ham_padded, _ = _frontend_constants(
        params, "float32")
    filt = np.concatenate([w_cos, w_sin], axis=1).T[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (filt, mel, dct, ham_padded))


def num_frames(num_samples, hop_length: int):
    """Frame count for center=True STFT: 1 + floor(L / hop)."""
    return 1 + num_samples // hop_length


def pack_waveform(clip: np.ndarray, buf_len: int, n_fft: int,
                  keep_int16: bool = False) -> np.ndarray:
    """Host-side packing of one variable-length clip into a fixed buffer.

    Applies the center=True reflect padding at the clip's *true* boundaries
    (n_fft//2 samples each side) so batched framing of the buffer is
    bit-identical to a per-clip STFT — the layout is
    [reflect_left | clip | reflect_right | zeros...]. `buf_len` must be
    >= len(clip) + n_fft. keep_int16=True keeps int16 samples; the device
    frontend applies the /32768 scaling after the transfer."""
    clip = np.asarray(clip)
    if keep_int16:
        if clip.dtype != np.int16:
            raise ValueError(f"keep_int16 needs int16 samples, got {clip.dtype}")
        out_dtype = np.int16
    else:
        if clip.dtype == np.int16:
            clip = (clip / 32768.0).astype(np.float32)
        clip = clip.astype(np.float32)
        out_dtype = np.float32
    pad = n_fft // 2
    L = clip.shape[0]
    if L + 2 * pad > buf_len:
        clip = clip[: buf_len - 2 * pad]
        L = clip.shape[0]
    out = np.zeros(buf_len, dtype=out_dtype)
    padded = np.pad(clip, (pad, pad), mode="reflect")
    out[: L + 2 * pad] = padded
    return out


def _frames_source(wav: torch.Tensor, n_fft: int, hop: int,
                   pre_padded: bool):
    """(padded waveform, frame count) for center=True framing."""
    B, L = wav.shape
    if pre_padded:
        return wav, num_frames(L - n_fft, hop)
    pad = n_fft // 2
    padded = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return padded, num_frames(L, hop)


def _stft_power_fft(wav: torch.Tensor, params: STFTParams,
                    pre_padded: bool = False) -> torch.Tensor:
    """Power spectrogram via explicit framing + rfft. wav (B, L) float ->
    (B, T, n_fft//2+1)."""
    n_fft, _, hop, _ = params
    ham_padded = torch_constants(params, wav.device)[3]
    padded, T = _frames_source(wav, n_fft, hop, pre_padded)
    frames = padded[:, : (T - 1) * hop + n_fft].unfold(-1, n_fft, hop)
    spec = torch.fft.rfft(frames * ham_padded, n=n_fft, dim=-1)
    return spec.abs() ** 2


def _stft_power_gemm(wav: torch.Tensor, params: STFTParams,
                     pre_padded: bool = False) -> torch.Tensor:
    """Power spectrogram as one strided convolution (framing + window +
    DFT): the window-folded DFT matrices act as conv1d filters of width
    win_length and stride hop_length. Returns a (B, T, F) *transposed view*
    of the (B, F, T) conv output."""
    n_fft, win, hop, _ = params
    off = _frontend_constants(params, "float32")[5]
    filt = torch_constants(params, wav.device)[0]
    padded, T = _frames_source(wav, n_fft, hop, pre_padded)
    # Frame t covers padded[t*hop : t*hop + n_fft]; only the window's
    # support [off, off+win) contributes.
    x = padded[:, off : off + (T - 1) * hop + win]
    out = F.conv1d(x[:, None, :], filt, stride=hop)  # (B, 2F, T)
    n_freqs = filt.shape[0] // 2
    re, im = out[:, :n_freqs], out[:, n_freqs:]
    return (re * re + im * im).transpose(1, 2)


def mfcc_from_power(power: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """mel -> log -> DCT on a (B, T, n_freqs) power spectrogram."""
    _, mel, dct, _ = torch_constants(params, power.device)
    return torch.log(power @ mel + LOG_EPS) @ dct


def mfcc_batch(wav: torch.Tensor, params: STFTParams, backend: str = "gemm",
               pre_padded: bool = False) -> torch.Tensor:
    """MFCC of a batch of equal-length waveforms. wav (B, L) -> (B, T, 40).

    With pre_padded=True, rows are pack_waveform() buffers (reflect padding
    already applied at true clip boundaries)."""
    if not torch.is_floating_point(wav):
        # int16 bank rows: normalise here, before any constant meets them
        wav = wav.float() * (1.0 / 32768.0)
    if backend == "fft":
        power = _stft_power_fft(wav, params, pre_padded)
    elif backend == "gemm":
        power = _stft_power_gemm(wav, params, pre_padded)
    elif backend == "pallas":
        from .mel_log_dct import mel_log_dct

        # the kernel reads the STFT's transposed view as it lies
        return mel_log_dct(_stft_power_gemm(wav, params, pre_padded), params)
    else:
        raise ValueError(f"unknown audio backend {backend!r}")
    return mfcc_from_power(power, params)


def sound_features(wav: torch.Tensor, lengths: torch.Tensor,
                   target_frames: int, params: STFTParams,
                   backend: str = "gemm",
                   zero_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full frontend: batched MFCC + frame masking + pad/truncate + channel.

    wav: (B, buf_len) pack_waveform() rows, int16 or float; lengths: (B,)
    valid sample counts; target_frames: config.sound_dim[1]; zero_mask:
    optional (B,) bool, True rows give all-zero features. Returns
    (B, 1, target_frames, 40) float32."""
    if not torch.is_floating_point(wav):
        wav = wav.float() * (1.0 / 32768.0)
    B, L = wav.shape
    T = num_frames(L - params.n_fft, params.hop_length)
    feats = mfcc_batch(wav, params, backend=backend, pre_padded=True)

    # zero the frames past each clip's true frame count
    n_valid = num_frames(lengths, params.hop_length)
    frame_ids = torch.arange(T, device=wav.device)[None, :]
    valid = frame_ids < n_valid[:, None]
    feats = torch.where(valid[:, :, None], feats, 0.0)

    if T >= target_frames:
        feats = feats[:, :target_frames, :]
    else:
        feats = F.pad(feats, (0, 0, 0, target_frames - T))

    if zero_mask is not None:
        feats = torch.where(zero_mask[:, None, None], 0.0, feats)
    return feats[:, None, :, :]


def _mfcc_numpy(wav: np.ndarray, params: STFTParams) -> np.ndarray:
    """Pure-numpy single-clip MFCC (identical math to the device paths);
    the host sims call it per clip."""
    n_fft, _, hop, _ = params
    w_cos, w_sin, mel, dct, _, off = _frontend_constants(params, "float32")
    L = wav.shape[0]
    T = int(num_frames(L, hop))
    padded = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    x = padded[off:]
    win = w_cos.shape[0]
    idx = (np.arange(T) * hop)[:, None] + np.arange(win)[None, :]
    frames = x[idx]  # (T, win)
    re = frames @ w_cos
    im = frames @ w_sin
    power = re * re + im * im
    return np.log(power @ mel + LOG_EPS) @ dct


def mfcc_single(wav: np.ndarray, params: STFTParams,
                backend: str = "numpy") -> np.ndarray:
    """Single-clip MFCC -> (frames, 40) numpy (host callers)."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        wav = (wav / 32768.0).astype(np.float32)
    wav = wav.astype(np.float32)
    if backend == "numpy":
        return _mfcc_numpy(wav, params)
    out = mfcc_batch(torch.from_numpy(wav[None, :]), params, backend=backend)
    return out[0].numpy()


def process_sound_feat(feat: np.ndarray, target_frames: int) -> np.ndarray:
    """Host-side pad-or-truncate to (1, target_frames, 40)."""
    feat = np.expand_dims(np.asarray(feat), axis=0)
    nf = feat.shape[1]
    if target_frames < nf:
        feat = feat[:, :target_frames, :]
    else:
        pad = np.zeros((1, target_frames - nf, feat.shape[2]), dtype=feat.dtype)
        feat = np.concatenate([feat, pad], axis=1)
    return feat


# -- python_speech_features semantics (host) ---------------------------------


def psf_filterbank(nfilt: int, n_fft: int, sample_rate: int,
                   lowfreq: float = 0.0, highfreq=None) -> np.ndarray:
    """python_speech_features.get_filterbanks: triangles on FFT bin
    indices floored from the HTK mel points (torchaudio's triangles sit on
    continuous frequencies). Returns (nfilt, n_fft//2+1)."""
    highfreq = highfreq or sample_rate / 2.0
    m_pts = np.linspace(hz_to_mel_htk(lowfreq), hz_to_mel_htk(highfreq),
                        nfilt + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz_htk(m_pts) / sample_rate)
    fb = np.zeros((nfilt, n_fft // 2 + 1))
    for j in range(nfilt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb


def mfcc_psf(wav: np.ndarray, params: STFTParams, numcep: int = 40,
             nfilt: int = 40, preemph: float = 0.97, ceplifter: int = 22,
             append_energy: bool = True) -> np.ndarray:
    """python_speech_features.mfcc with a hamming window -> (frames,
    numcep) float32: raw int16 amplitudes (no /32768), 0.97 pre-emphasis,
    uncentred frames (ceil count, zero tail), |rfft|^2/NFFT, the floored
    filterbank, eps for zero energies, ortho DCT-II of the log energies,
    sinusoidal lifter (L=22), log frame energy as coefficient 0."""
    n_fft, frame_len, frame_step, fs = params
    signal = np.asarray(wav, dtype=np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    slen = signal.shape[0]
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(math.ceil((1.0 * slen - frame_len) / frame_step))
    padlen = (numframes - 1) * frame_step + frame_len
    padded = np.concatenate([signal, np.zeros(padlen - slen)])
    idx = (np.arange(numframes)[:, None] * frame_step
           + np.arange(frame_len)[None, :])
    frames = padded[idx] * np.hamming(frame_len)[None, :]
    pspec = (np.abs(np.fft.rfft(frames, n_fft)) ** 2) / n_fft
    energy = pspec.sum(axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    feat = pspec @ psf_filterbank(nfilt, n_fft, fs).T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat) @ dct_matrix(numcep, nfilt)
    if ceplifter > 0:
        n = np.arange(numcep)
        feat = feat * (1.0 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter))
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat.astype(np.float32)
