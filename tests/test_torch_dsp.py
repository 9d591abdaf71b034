"""The port's DSP (``glow_tts_tpu_torch/ops/stft.py``, ``ops/yin.py``) on
the CPU against the JAX package's (``glow_tts_tpu/ops/stft.py``,
``ops/yin.py``), on the same seeded signals at 24 kHz, 1–3 s (noise, a
chirp, a harmonic stack) and one clip shorter than the STFT's 1024-sample
centre pad.

Tolerances:

* the mel filterbank, the reflection, preemphasis, trim and peak
  normalisation: bit-equal (the same numpy or the same f32 operations);
* the STFT magnitude: 1e-5 of its max-abs (FFTs of two libraries);
* the mel on the ±4 scale: max-abs 2e-3 (a quiet bin's relative rounding
  grows through the log);
* the pitch, by the near-tie rule: equal on every frame except those where
  JAX's CMND lies within ``NEAR_TIE`` of the threshold, or of its next lag
  on the walk to the dip's minimum; those are counted, and must be few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (the thread cap)
from glow_tts_tpu.ops import stft as jstft
from glow_tts_tpu.ops import yin as jyin
from glow_tts_tpu_torch.ops import stft, yin

SR = 24000
MEL_TOL = 2e-3
MAG_REL_TOL = 1e-5
NEAR_TIE = 1e-5
MAX_NEAR_TIE_SHARE = 0.05


def signal(kind, seconds=None, seed=0):
    rng = np.random.default_rng(seed)
    n = int(SR * seconds) if seconds else 700
    t = np.arange(n) / SR
    if kind == 'noise':
        x = 0.3 * rng.standard_normal(n)
    elif kind == 'chirp':
        x = 0.5 * np.sin(2 * np.pi * (120 * t + 60 * t ** 2))
    else:                                     # a harmonic stack, f0 180 Hz
        x = sum(np.sin(2 * np.pi * k * 180.0 * t + rng.uniform(0, 6)) / k
                for k in range(1, 20)) * 0.2
    return x.astype(np.float32)


SIGNALS = {'noise': ('noise', 1.0), 'chirp': ('chirp', 1.5),
           'harmonic': ('harmonic', 3.0), 'short': ('harmonic', None)}


@pytest.fixture(scope='module', params=list(SIGNALS))
def audio(request):
    kind, seconds = SIGNALS[request.param]
    return signal(kind, seconds, seed=len(request.param))


@pytest.mark.parametrize('n,pad', [(5, 12), (700, 1024), (1, 3), (2, 5),
                                   (4096, 1024)])
def test_reflection_is_numpys_also_past_the_signal(n, pad):
    x = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(x[stft.reflect_indices(n, pad, pad + 1)],
                                  np.pad(x, (pad, pad + 1), mode='reflect'))
    np.testing.assert_array_equal(
        stft.reflect_pad(torch.as_tensor(x), pad, pad).numpy(),
        np.pad(x, pad, mode='reflect'))


@pytest.mark.parametrize('args', [(24000, 2048, 80, 125.0, 7600.0),
                                  (1600, 128, 8, 50.0, 600.0),
                                  (22050, 1024, 80, 0.0, 8000.0)])
def test_mel_filterbank_bit_equal(args):
    np.testing.assert_array_equal(stft.mel_filterbank(*args),
                                  jstft.mel_filterbank(*args))


def test_preemphasis_and_window(audio):
    x = np.stack([audio, audio[::-1]])
    np.testing.assert_array_equal(
        stft.preemphasis(torch.as_tensor(x)).numpy(),
        np.asarray(jstft.preemphasis(jnp.asarray(x))))
    for n in (64, 1024):
        np.testing.assert_allclose(stft.hann_window(n).numpy(),
                                   np.asarray(jstft.hann_window(n)),
                                   rtol=0, atol=1e-7)


def test_stft_magnitude(audio):
    got = stft.stft_magnitude(torch.as_tensor(audio), 2048, 256, 1024).numpy()
    ref = np.asarray(jstft.stft_magnitude(jnp.asarray(audio), 2048, 256,
                                          1024))
    assert got.shape == ref.shape == (1 + audio.shape[0] // 256, 1025)
    assert np.abs(got - ref).max() <= MAG_REL_TOL * np.abs(ref).max()


def test_mel_spectrogram_on_the_device_path(audio):
    got = stft.mel_spectrogram(torch.as_tensor(audio)).numpy()
    ref = np.asarray(jstft.mel_spectrogram(jnp.asarray(audio)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= MEL_TOL


def test_mel_spectrogram_host_equals_jaxs_bucketed_one(audio):
    """No length bucket in the port; the frames are the same."""
    got = stft.mel_spectrogram_host(audio, device='cpu')
    ref = jstft.mel_spectrogram_host(audio)
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (1 + audio.shape[0] // 256, 80)
    assert np.abs(got - ref).max() <= MEL_TOL
    assert got.min() >= -4.0 and got.max() <= 4.0


def test_trim_and_normalise_bit_equal(audio):
    quiet = np.concatenate([np.zeros(3000, np.float32), audio,
                            1e-4 * audio[:2000]])
    for top_db in (15, 30, 60):
        np.testing.assert_array_equal(
            stft.trim_silence(quiet, top_db=top_db),
            jstft.trim_silence(quiet, top_db=top_db))
    np.testing.assert_array_equal(stft.normalize_audio(quiet),
                                  jstft.normalize_audio(quiet))
    assert stft.trim_silence(np.zeros(0, np.float32)).size == 0


def jax_cmnd(padded, w_len, w_step, tau_max):
    """JAX's CMND, by the expressions of ``glow_tts_tpu/ops/yin.py``."""
    n = padded.shape[0]
    num_frames = len(range(0, n - w_len, w_step))
    idx = np.arange(num_frames)[:, None] * w_step + np.arange(w_len)[None]
    frames = jnp.asarray(padded)[idx]
    energy = jnp.concatenate([jnp.zeros_like(frames[:, :1]),
                              jnp.cumsum(frames * frames, axis=-1)], axis=-1)
    fft_size = yin._next_fft_size(w_len + tau_max)
    spec = jnp.fft.rfft(frames, n=fft_size, axis=-1)
    acf = jnp.fft.irfft(spec * jnp.conj(spec), n=fft_size,
                        axis=-1)[:, :tau_max]
    taus = jnp.arange(tau_max)
    df = (energy[:, w_len][:, None] + jnp.take(energy, w_len - taus, axis=-1)
          - energy[:, :tau_max] - 2.0 * acf)
    cums = jnp.cumsum(df[:, 1:], axis=-1)
    return np.asarray(jnp.concatenate(
        [jnp.ones_like(df[:, :1]),
         df[:, 1:] * jnp.arange(1, tau_max) / (cums + 1e-8)], axis=-1))


def near_ties(cmnd, thresh, tau_min):
    """Frames whose pitch a last-bit difference of the CMND can move: the
    CMND near the threshold, or two lags on the walk to the dip near but
    not exactly equal (silence gives exact zeros, equal on both sides)."""
    tau_max = cmnd.shape[1]
    in_range = np.arange(tau_max) >= tau_min
    at_threshold = (np.abs(cmnd - thresh) < NEAR_TIE) & in_range
    below = (cmnd < thresh) & in_range
    first = np.where(below.any(1), below.argmax(1), tau_max)
    step = np.abs(np.diff(cmnd, axis=1))                    # tau vs tau + 1
    steps = (0 < step) & (step < NEAR_TIE)
    on_walk = np.arange(tau_max - 1)[None] >= first[:, None]
    return at_threshold.any(1) | (steps & on_walk).any(1)


def test_pitch_by_the_near_tie_rule(audio):
    got = yin.pitch_calc(audio, SR, device='cpu')
    ref = jyin.pitch_calc(audio, SR)
    assert got.dtype == np.float32 and got.shape == ref.shape
    tau_min, tau_max = int(SR / 500.0), int(SR / 100.0)
    cmnd = jax_cmnd(yin.pad_for_yin(audio), 1024, 256, tau_max)
    ties = near_ties(cmnd, 0.4, tau_min)
    print(f'near-tie frames: {int(ties.sum())} of {ties.size}')
    assert ties.sum() <= MAX_NEAR_TIE_SHARE * max(ties.size, 20)
    np.testing.assert_array_equal(got[~ties], ref[~ties])
    np.testing.assert_array_equal(yin.normalize_pitch(got[~ties]),
                                  jyin.normalize_pitch(ref[~ties]))


def test_pitch_smoothing_branch(audio):
    """scipy's gaussian filter on the host, on the track as JAX's is."""
    from scipy.ndimage import gaussian_filter1d
    got = yin.pitch_calc(audio, SR, gaussian_smoothing_sigma=1.5,
                         device='cpu')
    plain = yin.pitch_calc(audio, SR, device='cpu')
    np.testing.assert_array_equal(got, gaussian_filter1d(plain, sigma=1.5))
    ref = jyin.pitch_calc(audio, SR, gaussian_smoothing_sigma=1.5)
    if np.array_equal(plain, jyin.pitch_calc(audio, SR)):
        np.testing.assert_array_equal(got, ref)


def test_yin_frames_and_the_cmnd(audio):
    padded = yin.pad_for_yin(audio)
    got = yin.yin_cmnd(torch.as_tensor(padded), 1024, 256, 240).numpy()
    ref = jax_cmnd(padded, 1024, 256, 240)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    frames = yin.compute_yin_frames(torch.as_tensor(padded), SR).numpy()
    assert frames.shape == (ref.shape[0],) and frames.dtype == np.float32


def test_yin_finds_a_sine():
    t = np.arange(SR) / SR
    tone = (0.6 * np.sin(2 * np.pi * 200.0 * t)).astype(np.float32)
    pitch = yin.pitch_calc(tone, SR, device='cpu')
    voiced = pitch[pitch > 0]
    assert voiced.size > 0.8 * pitch.size
    assert np.abs(np.median(voiced) - 200.0) < 2.0


def test_the_dsp_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip('CUDA is available')
    with pytest.raises(RuntimeError, match='CUDA'):
        stft.mel_spectrogram_host(signal('noise', 0.1))
    with pytest.raises(RuntimeError, match='CUDA'):
        yin.pitch_calc(signal('noise', 0.1), SR)
