"""YIN fundamental-frequency estimation on a torch device, all frames at
once: one batched rFFT gives every frame's difference function, and the
threshold search and the walk to the local minimum are masked ``argmax``es
(the port of ``glow_tts_tpu/ops/yin.py``).

The semantics of the JAX package's version:

* centre padding by ``(w_step + w_len - n % w_step) // 2`` samples,
  reflected (again and again on a clip shorter than the pad);
* frames at ``range(0, n - w_len, w_step)``;
* the difference function from the cumulative energy and the FFT
  autocorrelation; the cumulative-mean-normalised difference (CMND) with
  a +1e-8 guard;
* the pitch: the first lag under the harmonicity threshold, then forward
  while the CMND decreases; 0 where no lag is under it;
* ``pitch_calc``'s threshold ``1 - confidence``.
"""

from __future__ import annotations

import numpy as np
import torch

from glow_tts_tpu_torch.ops.stft import Device, card_or_cpu, reflect_indices


def _next_fft_size(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first ``True`` along the last axis (0 where none):
    ``argmax`` refuses bool, and returns the first of equal maxima."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def yin_cmnd(audio: torch.Tensor, w_len: int = 1024, w_step: int = 256,
             tau_max: int = 240) -> torch.Tensor:
    """The CMND ``[frames, tau_max]`` of a 1-D signal (already padded),
    frames at ``range(0, n - w_len, w_step)``."""
    num_frames = len(range(0, audio.shape[-1] - w_len, w_step))
    frames = audio[:num_frames * w_step + w_len - w_step].unfold(
        -1, w_len, w_step) if num_frames else audio.new_zeros((0, w_len))
    energy = torch.cat([torch.zeros_like(frames[:, :1]),
                        torch.cumsum(frames * frames, dim=-1)], dim=-1)
    fft_size = _next_fft_size(w_len + tau_max)
    spec = torch.fft.rfft(frames, n=fft_size, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), n=fft_size,
                          dim=-1)[:, :tau_max]             # [F, tau_max]
    taus = torch.arange(tau_max, device=audio.device)
    df = (energy[:, w_len][:, None]                        # E[w]
          + energy[:, w_len - taus]                        # E[w - tau]
          - energy[:, :tau_max]                            # E[tau]
          - 2.0 * acf)
    cums = torch.cumsum(df[:, 1:], dim=-1)
    lags = torch.arange(1, tau_max, device=audio.device)
    return torch.cat([torch.ones_like(df[:, :1]),
                      df[:, 1:] * lags / (cums + 1e-8)], dim=-1)


def compute_yin_frames(audio: torch.Tensor,
                       sample_rate: int,
                       w_len: int = 1024,
                       w_step: int = 256,
                       f0_min: float = 100.0,
                       f0_max: float = 500.0,
                       harmo_thresh: float = 0.4) -> torch.Tensor:
    """Per-frame pitch of a 1-D float32 signal (already centre-padded), on
    its device: ``[frames]`` in Hz, 0 where unvoiced."""
    tau_min = int(sample_rate / f0_max)
    tau_max = int(sample_rate / f0_min)
    cmdf = yin_cmnd(audio, w_len, w_step, tau_max)
    taus = torch.arange(tau_max, device=audio.device)
    # the first lag below the threshold within [tau_min, tau_max)
    below = (cmdf < harmo_thresh) & (taus >= tau_min)
    voiced = below.any(dim=-1)
    first = first_true(below)
    # then forward while the CMND keeps decreasing (the dip's minimum)
    nxt = torch.cat([cmdf[:, 1:], torch.full_like(cmdf[:, :1], torch.inf)],
                    dim=-1)
    cont = (taus + 1 < tau_max) & (nxt < cmdf)
    lag = torch.clamp(first_true((taus[None, :] >= first[:, None]) & ~cont),
                      min=1)
    # f32(rate) / f32(lag), rounded once (a scalar over an integer tensor
    # multiplies by the reciprocal, one ulp off)
    hz = torch.full(lag.shape, float(sample_rate), device=audio.device) / lag
    return torch.where(voiced, hz, 0.0).to(torch.float32)


def pad_for_yin(audio: np.ndarray, w_len: int = 1024,
                w_step: int = 256) -> np.ndarray:
    """The centre padding of :func:`pitch_calc`, by reflection."""
    pad = (w_step + w_len - audio.shape[0] % w_step) // 2
    return audio[reflect_indices(audio.shape[0], pad, pad)]


def pitch_calc(audio,
               sample_rate: int,
               w_len: int = 1024,
               w_step: int = 256,
               f0_min: float = 100.0,
               f0_max: float = 500.0,
               confidence_threshold: float = 0.6,
               gaussian_smoothing_sigma: float = 0.0,
               device: Device = 'cuda') -> np.ndarray:
    """The pitch track of one utterance, aligned with its mel frames:
    float32 ``[frames]`` in Hz; the YIN on ``device``, the optional
    gaussian smoothing on the host (scipy)."""
    device = card_or_cpu(device)
    padded = pad_for_yin(np.asarray(audio, dtype=np.float32), w_len, w_step)
    pitches = compute_yin_frames(
        torch.as_tensor(padded, device=device), sample_rate, w_len=w_len,
        w_step=w_step, f0_min=f0_min, f0_max=f0_max,
        harmo_thresh=1.0 - confidence_threshold).cpu().numpy()
    if gaussian_smoothing_sigma > 0.0:
        from scipy.ndimage import gaussian_filter1d
        pitches = gaussian_filter1d(pitches, sigma=gaussian_smoothing_sigma)
    return pitches


def normalize_pitch(pitch: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1]."""
    return (pitch - pitch.min()) / (pitch.max() - pitch.min() + 1e-7)
