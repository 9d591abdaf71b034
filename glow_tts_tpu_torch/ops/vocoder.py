"""Griffin-Lim vocoder on a torch device: normalised mel → waveform (the
port of ``glow_tts_tpu/ops/vocoder.py``).

It inverts the mel pipeline of :mod:`glow_tts_tpu_torch.ops.stft`: the dB
normalisation undone, the filterbank's pseudo-inverse (made in numpy, as
the JAX package makes it), phase recovery by Griffin-Lim on the mel's
device, then the inverse preemphasis on the host.

What differs from the JAX package, and why:

* the overlap-add of the inverse STFT sums the ``ceil(n_fft / hop)``
  shifted frame slabs in a fixed order (no scatter-add: on the card an
  indexed add sums with atomics), so an export repeats bit for bit;
* the start phase is uniform in [-π, π) from a ``torch.Generator`` (seed 0
  unless one is given), or the ``angles`` the caller passes: no torch
  generator repeats ``jax.random``'s stream;
* the inverse preemphasis, a first-order recursion over every sample, is
  ``scipy.signal.lfilter`` on the host in float32: the same multiply and
  add per sample as the JAX package's f32 ``lax.scan``;
* ``mel_to_audio`` clamps the mel to ``±max_abs_mel`` first, where the
  JAX package's export overflows into NaNs.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from glow_tts_tpu_torch.ops.stft import (Device, card_or_cpu, frames_of,
                                         mel_filterbank, padded_window,
                                         reflect_pad)


@functools.lru_cache(maxsize=8)
def inverse_filterbank(sample_rate: int, n_fft: int, num_mel: int,
                       mel_fmin: float, mel_fmax: float) -> np.ndarray:
    """The pseudo-inverse ``[num_mel, n_fft//2 + 1]`` of the filterbank."""
    return np.linalg.pinv(mel_filterbank(sample_rate, n_fft, num_mel,
                                         mel_fmin, mel_fmax))


def mel_to_magnitude(mel: torch.Tensor,
                     sample_rate: int,
                     num_frequency: int,
                     num_mel: int,
                     mel_fmin: float,
                     mel_fmax: float,
                     min_level_db: float = -100.0,
                     max_abs_value: float = 4.0,
                     power: float = 1.2) -> torch.Tensor:
    """``[..., T, M]`` normalised mel → ``[..., T, F]`` linear magnitude:
    the dB normalisation undone, lifted to the linear frequencies by the
    filterbank's pseudo-inverse; ``power`` > 1 sharpens."""
    n_fft = (num_frequency - 1) * 2
    db = ((mel + max_abs_value) * (-min_level_db)
          / (2.0 * max_abs_value)) + min_level_db
    amplitude = torch.pow(10.0, db / 20.0)
    inv_fb = torch.as_tensor(inverse_filterbank(
        sample_rate, n_fft, num_mel, mel_fmin, mel_fmax), device=mel.device)
    return torch.pow(torch.clamp(amplitude @ inv_fb, min=1e-10), power)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``[T, n]`` frames, frame t starting at sample t·hop → the summed
    signal ``[n + hop·(T - 1)]``, summed slab by slab in a fixed order."""
    num_frames, n = frames.shape
    slabs = -(-n // hop_length)
    frames = torch.nn.functional.pad(frames, (0, slabs * hop_length - n))
    frames = frames.reshape(num_frames, slabs, hop_length)
    chunks = num_frames + slabs - 1
    out = frames.new_zeros((chunks, hop_length))
    for r in range(slabs):
        out[r:r + num_frames] += frames[:, r]
    return out.reshape(-1)[:n + hop_length * (num_frames - 1)]


def _istft(spec: torch.Tensor, n_fft: int, hop_length: int,
           win_length: int) -> torch.Tensor:
    """Inverse STFT with hann overlap-add (librosa's conventions,
    centred): ``[frames, n_fft//2 + 1]`` complex → ``[samples]``."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)          # [T, n_fft]
    window = padded_window(n_fft, win_length, frames.dtype, frames.device)
    audio = overlap_add(frames * window, hop_length)
    norm = overlap_add((window ** 2).expand(frames.shape[0], n_fft),
                       hop_length)
    audio = audio / torch.clamp(norm, min=1e-8)
    return audio[n_fft // 2: audio.shape[0] - n_fft // 2]   # the centre pad


def _stft_complex(audio: torch.Tensor, n_fft: int, hop_length: int,
                  win_length: int) -> torch.Tensor:
    """The complex STFT ``[frames, n_fft//2 + 1]``, centred by reflection."""
    audio = reflect_pad(audio, n_fft // 2, n_fft // 2)
    window = padded_window(n_fft, win_length, audio.dtype, audio.device)
    return torch.fft.rfft(frames_of(audio, n_fft, hop_length) * window,
                          n=n_fft, dim=-1)


def start_angles(shape, device: Device = 'cpu',
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Griffin-Lim's start phase, uniform in [-π, π) on ``device``, from
    ``generator`` (one seeded with 0 on that device unless given)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return (torch.rand(shape, generator=generator, device=device)
            * (2.0 * torch.pi) - torch.pi)


def griffin_lim(magnitude: torch.Tensor,
                n_fft: int,
                hop_length: int,
                win_length: int,
                iterations: int = 60,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase recovery on the magnitude's device: ``[T, F]`` → ``[samples]``.
    The start phase is ``angles`` if given, else :func:`start_angles`."""
    if angles is None:
        angles = start_angles(magnitude.shape, magnitude.device, generator)
    spec = magnitude * torch.exp(1j * angles.to(magnitude.device))
    for _ in range(iterations):
        audio = _istft(spec, n_fft, hop_length, win_length)
        rebuilt = _stft_complex(audio, n_fft, hop_length,
                                win_length)[:magnitude.shape[0]]
        spec = magnitude * (rebuilt / torch.clamp(rebuilt.abs(), min=1e-10))
    return _istft(spec, n_fft, hop_length, win_length)


def inverse_preemphasis(audio: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """IIR y[n] = x[n] + coef·y[n-1] (inverse of the analysis FIR), on the
    host in float32."""
    from scipy.signal import lfilter
    audio = np.asarray(audio, dtype=np.float32)
    return lfilter(np.float32([1.0]), np.float32([1.0, -coef]), audio)


def mel_to_audio(mel,
                 sound_config,
                 iterations: int = 60,
                 power: float = 1.2,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None,
                 angles: Optional[torch.Tensor] = None) -> np.ndarray:
    """Normalised mel ``[T, M]`` → float32 waveform, peak-normalised.
    Griffin-Lim runs on ``device``: the mel's if it is a tensor and no
    device is given, else the card.  The mel is first clamped to the
    ``±max_abs_mel`` range the ETL's mels live in: an untrained model's
    free-running decode can leave it, and 10^(dB/20) then overflows f32
    into a waveform of NaNs."""
    if device is None:
        device = mel.device if isinstance(mel, torch.Tensor) else 'cuda'
    device = card_or_cpu(device)
    limit = sound_config.max_abs_mel
    magnitude = mel_to_magnitude(
        torch.as_tensor(mel, dtype=torch.float32, device=device).clamp(
            -limit, limit),
        sample_rate=sound_config.sample_rate,
        num_frequency=sound_config.spectrogram_dim,
        num_mel=sound_config.mel_dim,
        mel_fmin=sound_config.mel_f_min,
        mel_fmax=sound_config.mel_f_max,
        max_abs_value=sound_config.max_abs_mel,
        power=power)
    n_fft = (sound_config.spectrogram_dim - 1) * 2
    audio = griffin_lim(magnitude, n_fft, sound_config.frame_shift,
                        sound_config.frame_length, iterations=iterations,
                        generator=generator, angles=angles)
    audio = inverse_preemphasis(audio.cpu().numpy())
    peak = np.abs(audio).max()
    return (audio / peak if peak > 0 else audio).astype(np.float32)


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM wav of ``audio`` clipped to [-1, 1]."""
    from scipy.io import wavfile
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sample_rate,
                  (np.clip(audio, -1, 1) * 32767).astype(np.int16))
