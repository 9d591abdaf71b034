"""The port's Griffin-Lim vocoder (``glow_tts_tpu_torch/ops/vocoder.py``) on
the CPU against the JAX package's (``glow_tts_tpu/ops/vocoder.py``), on
seeded mels at MiniSpeech's sound settings (24 kHz, n_fft 2048, hop 256,
window 1024), a few dozen frames.

Tolerances, each relative to the reference's max-abs: the magnitude,
the inverse and forward STFT 1e-5; Griffin-Lim with JAX's own start phase
after 1 and after 60 iterations 1e-5; the inverse preemphasis against
JAX's f32 scan 1e-6; the peak-normalised waveform 1e-5 absolute; the wav
file bit for bit.  The pseudo-inverse filterbank is the same numpy call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (the thread cap)
from glow_tts_tpu.config import load_config as jax_load_config
from glow_tts_tpu.ops import vocoder as jvocoder
from glow_tts_tpu_torch.config import load_config
from glow_tts_tpu_torch.ops import vocoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINISPEECH = os.path.join(REPO, 'configs', 'MiniSpeech.yaml')
N_FFT, HOP, WIN = 2048, 256, 1024
REL_TOL = 1e-5
FRAMES = 24


def rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope='module')
def mel():
    rng = np.random.default_rng(0)
    return np.clip(rng.normal(-1.0, 1.2, (FRAMES, 80)), -4, 4
                   ).astype(np.float32)


@pytest.fixture(scope='module')
def magnitude(mel):
    return np.asarray(jvocoder.mel_to_magnitude(
        jnp.asarray(mel), 24000, 1025, 80, 125, 7600))


@pytest.fixture(scope='module')
def jax_angles(magnitude):
    """JAX's start phase of ``griffin_lim(seed=0)``."""
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), magnitude.shape, minval=-jnp.pi,
        maxval=jnp.pi))


def test_mel_to_magnitude(mel, magnitude):
    got = vocoder.mel_to_magnitude(torch.as_tensor(mel), 24000, 1025, 80,
                                   125, 7600).numpy()
    assert got.shape == magnitude.shape == (FRAMES, 1025)
    assert rel_err(got, magnitude) <= REL_TOL
    np.testing.assert_array_equal(
        vocoder.inverse_filterbank(24000, N_FFT, 80, 125, 7600),
        np.linalg.pinv(jvocoder.mel_filterbank(24000, N_FFT, 80, 125, 7600)))


def test_istft_and_stft(magnitude):
    rng = np.random.default_rng(1)
    spec = (magnitude * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                magnitude.shape))
            ).astype(np.complex64)
    ref = np.asarray(jvocoder._istft(jnp.asarray(spec), N_FFT, HOP, WIN))
    got = vocoder._istft(torch.as_tensor(spec), N_FFT, HOP, WIN).numpy()
    assert got.shape == ref.shape == (HOP * (FRAMES - 1),)
    assert rel_err(got, ref) <= REL_TOL
    ref_spec = np.asarray(jvocoder._stft_complex(jnp.asarray(ref), N_FFT,
                                                 HOP, WIN))
    got_spec = vocoder._stft_complex(torch.as_tensor(ref), N_FFT, HOP,
                                     WIN).numpy()
    assert got_spec.shape == ref_spec.shape == (FRAMES, 1025)
    assert rel_err(got_spec, ref_spec) <= REL_TOL


@pytest.mark.parametrize('n,hop', [(2048, 256), (100, 30), (64, 16)])
def test_overlap_add_is_the_scatter_add(n, hop):
    frames = np.random.default_rng(n).standard_normal((7, n)).astype(
        np.float32)
    ref = np.zeros(n + hop * 6)
    for t, frame in enumerate(frames):
        ref[t * hop:t * hop + n] += frame
    got = vocoder.overlap_add(torch.as_tensor(frames), hop).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('iterations', [1, 60])
def test_griffin_lim_with_jaxs_angles(magnitude, jax_angles, iterations):
    ref = np.asarray(jvocoder.griffin_lim(jnp.asarray(magnitude), N_FFT, HOP,
                                          WIN, iterations=iterations))
    got = vocoder.griffin_lim(torch.as_tensor(magnitude), N_FFT, HOP, WIN,
                              iterations=iterations,
                              angles=torch.as_tensor(jax_angles)).numpy()
    assert got.shape == ref.shape == (HOP * (FRAMES - 1),)
    assert rel_err(got, ref) <= REL_TOL


def test_griffin_lim_start_phase_is_seeded(magnitude):
    mag = torch.as_tensor(magnitude)
    angles = vocoder.start_angles(mag.shape)
    assert angles.min() >= -np.pi and angles.max() < np.pi
    a = vocoder.griffin_lim(mag, N_FFT, HOP, WIN, iterations=2)
    b = vocoder.griffin_lim(mag, N_FFT, HOP, WIN, iterations=2,
                            angles=angles)
    assert torch.equal(a, b)
    c = vocoder.griffin_lim(mag, N_FFT, HOP, WIN, iterations=2,
                            generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, c)


def test_inverse_preemphasis_against_the_scan():
    x = np.random.default_rng(2).standard_normal(50000).astype(np.float32)
    ref = np.asarray(jvocoder.inverse_preemphasis(jnp.asarray(x)))
    got = vocoder.inverse_preemphasis(x)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-6


def test_mel_to_audio_and_save_wav(mel, jax_angles, tmp_path):
    ref = jvocoder.mel_to_audio(mel, jax_load_config(MINISPEECH).sound)
    got = vocoder.mel_to_audio(mel, load_config(MINISPEECH).sound,
                               device='cpu',
                               angles=torch.as_tensor(jax_angles))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got).max() == 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    jvocoder.save_wav(str(tmp_path / 'jax.wav'), ref, 24000)
    vocoder.save_wav(str(tmp_path / 'sub' / 'port.wav'), ref, 24000)
    assert ((tmp_path / 'jax.wav').read_bytes()
            == (tmp_path / 'sub' / 'port.wav').read_bytes())
