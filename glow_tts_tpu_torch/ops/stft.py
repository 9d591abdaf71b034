"""Audio DSP on a torch device: preemphasis, STFT magnitude, mel
spectrogram; and the host-side trim and peak normalisation.

The port of ``glow_tts_tpu/ops/stft.py``, with its conventions:

* preemphasis FIR ``y[n] = x[n] - 0.97·x[n-1]``;
* STFT: ``n_fft = (num_frequency - 1)·2``, a periodic hann window of
  ``win_length`` zero-padded to ``n_fft``, hop ``hop_length``, centre
  padding by reflection (librosa's), ``torch.fft.rfft`` over frames, the
  result frame-major ``[..., frames, n_fft//2 + 1]``;
* the slaney-scale, slaney-normalised mel filterbank, made in numpy (the
  same numbers as the JAX package's);
* ``20·log10(mel + 1e-7)`` mapped into ``[-max_abs, max_abs]``.

The reflection reflects again and again where the pad is wider than the
signal, as ``np.pad``/``jnp.pad`` do (``F.pad`` refuses that), so a clip
shorter than ``n_fft / 2`` samples has a spectrogram too.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device]


def card_or_cpu(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names a card and
    CUDA is absent (the DSP never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           f'available; pass device="cpu" to run on the CPU')
    return device


def reflect_indices(n: int, left: int, right: int) -> np.ndarray:
    """Indices into a signal of ``n`` samples that pad it by reflection,
    ``left`` before and ``right`` after, repeating the reflection where a
    pad is wider than the signal (``np.pad(mode='reflect')``)."""
    idx = np.arange(-left, n + right)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Pad the last axis of ``x`` by reflection, the indices of
    :func:`reflect_indices` made on ``x``'s device."""
    n = x.shape[-1]
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(idx)]
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return x[..., torch.where(idx >= n, period - idx, idx)]


def preemphasis(audio: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """First-order high-pass FIR: y[n] = x[n] - coef·x[n-1]."""
    return torch.cat([audio[..., :1], audio[..., 1:] - coef * audio[..., :-1]],
                     dim=-1)


def hann_window(win_length: int, dtype=torch.float32,
                device: Device = 'cpu') -> torch.Tensor:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


def padded_window(n_fft: int, win_length: int, dtype=torch.float32,
                  device: Device = 'cpu') -> torch.Tensor:
    """The hann window centred in ``n_fft`` samples (librosa's)."""
    window = hann_window(win_length, dtype, device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(
            window, (lpad, n_fft - win_length - lpad))
    return window


def frames_of(audio: torch.Tensor, n_fft: int,
              hop_length: int) -> torch.Tensor:
    """``[..., samples]`` → ``[..., 1 + (samples - n_fft) // hop, n_fft]``."""
    return audio.unfold(-1, n_fft, hop_length)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True) -> torch.Tensor:
    """|STFT| with librosa conventions: ``[..., samples]`` →
    ``[..., frames, n_fft//2 + 1]``."""
    if center:
        audio = reflect_pad(audio, n_fft // 2, n_fft // 2)
    window = padded_window(n_fft, win_length, audio.dtype, audio.device)
    frames = frames_of(audio, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs()


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular mel filterbank
    ``[n_fft//2 + 1, n_mels]`` (transposed against librosa's, for a
    product on the right), float32."""

    def hz_to_mel(f):
        # Slaney: linear below 1 kHz, log above.
        f = np.asarray(f, dtype=np.float64)
        min_log_hz = 1000.0
        lin = f / (200.0 / 3.0)
        step = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        15.0 + np.log(np.maximum(f, 1e-10) / min_log_hz) / step,
                        lin)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        min_log_mel = 15.0
        step = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        1000.0 * np.exp(step * (m - min_log_mel)),
                        (200.0 / 3.0) * m)

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]       # [n_mels+2, n_freq]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, n_freq]

    # Slaney normalisation: each triangle integrates to ~2/bandwidth.
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.T.astype(np.float32)                  # [n_freq, n_mels]


def magnitude_to_mel(magnitude: torch.Tensor, sample_rate: int, n_fft: int,
                     num_mel: int, mel_fmin: float, mel_fmax: float,
                     min_level_db: float, max_abs_value: float
                     ) -> torch.Tensor:
    """``[..., frames, F]`` magnitude → the normalised mel
    ``[..., frames, num_mel]`` in ``[-max_abs_value, max_abs_value]``."""
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, num_mel,
                                        mel_fmin, mel_fmax),
                         device=magnitude.device)
    db = 20.0 * torch.log10(magnitude @ fb + 1e-7)
    return torch.clamp(
        (2.0 * max_abs_value) * (db - min_level_db) / (-min_level_db)
        - max_abs_value, -max_abs_value, max_abs_value)


def mel_spectrogram(audio: torch.Tensor,
                    sample_rate: int = 24000,
                    num_frequency: int = 1025,
                    num_mel: int = 80,
                    window_length: int = 1024,
                    hop_length: int = 256,
                    pre_emphasis: float = 0.97,
                    mel_fmin: float = 125.0,
                    mel_fmax: float = 7600.0,
                    min_level_db: float = -100.0,
                    max_abs_value: float = 4.0,
                    center: bool = True) -> torch.Tensor:
    """The mel pipeline on ``audio``'s device: ``[..., samples]`` → mel
    ``[..., frames, num_mel]`` in ``[-max_abs_value, max_abs_value]``.
    ``center=False`` takes audio the caller already padded."""
    n_fft = (num_frequency - 1) * 2
    magnitude = stft_magnitude(preemphasis(audio, pre_emphasis), n_fft,
                               hop_length, window_length, center=center)
    return magnitude_to_mel(magnitude, sample_rate, n_fft, num_mel, mel_fmin,
                            mel_fmax, min_level_db, max_abs_value)


def mel_spectrogram_host(audio: np.ndarray,
                         sample_rate: int = 24000,
                         num_frequency: int = 1025,
                         num_mel: int = 80,
                         window_length: int = 1024,
                         hop_length: int = 256,
                         device: Device = 'cuda',
                         pre_emphasis: float = 0.97,
                         mel_fmin: float = 125.0,
                         mel_fmax: float = 7600.0,
                         min_level_db: float = -100.0,
                         max_abs_value: float = 4.0) -> np.ndarray:
    """The ETL's mel of one utterance: float32 ``[1 + n // hop, num_mel]``.
    Preemphasis and the reflection run in numpy on the host, as the JAX
    package's ETL does, and the STFT and the filterbank on ``device``."""
    device = card_or_cpu(device)
    n_fft = (num_frequency - 1) * 2
    emphasized = np.concatenate(
        [audio[:1], audio[1:] - pre_emphasis * audio[:-1]]).astype(np.float32)
    padded = emphasized[reflect_indices(emphasized.shape[0], n_fft // 2,
                                        n_fft // 2)]
    magnitude = stft_magnitude(torch.as_tensor(padded, device=device), n_fft,
                               hop_length, window_length, center=False)
    return magnitude_to_mel(magnitude, sample_rate, n_fft, num_mel,
                            float(mel_fmin), float(mel_fmax),
                            float(min_level_db), float(max_abs_value)
                            ).cpu().numpy()


def trim_silence(audio: np.ndarray,
                 top_db: float = 60.0,
                 frame_length: int = 512,
                 hop_length: int = 256) -> np.ndarray:
    """Leading and trailing silence trim on the host (librosa's
    ``effects.trim``): drop edge frames quieter than ``max_db - top_db``,
    a frame's power being its RMS²."""
    if audio.size == 0:
        return audio
    # frame the signal (centred, like librosa.feature.rms with center=True)
    padded = np.pad(audio, frame_length // 2, mode='constant')
    n = 1 + (padded.shape[0] - frame_length) // hop_length
    idx = (np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :])
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=-1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return audio[:0]
    start = int(keep[0] * hop_length)
    end = min(audio.shape[0], int((keep[-1] + 1) * hop_length))
    return audio[start:end]


def normalize_audio(audio: np.ndarray) -> np.ndarray:
    """Peak-normalise (librosa's ``util.normalize`` default)."""
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio
