"""The port's audio decoding (``glow_tts_tpu_torch/data/audio_io.py``) and
its own FLAC codec (``data/flac.py``) against the JAX package's copies
(``glow_tts_tpu/data/audio_io.py``, ``data/flac.py``): the same samples
decoded, the same bytes encoded, the same errors; ``load_audio`` on wav,
FLAC (through the pure codec: this image has no soundfile), stereo and
resampled input, and the loud error for an m4a with no decoder.  All of it
bit-equal: both sides are the same numpy and scipy code."""

import hashlib

import numpy as np
import pytest
from scipy.io import wavfile

import tests.torch_port_helpers  # noqa: F401  (the thread cap)
from glow_tts_tpu.data import audio_io as jaudio_io
from glow_tts_tpu.data import flac as jflac
from glow_tts_tpu_torch.data import audio_io, flac
from tests.test_etl_all_corpora import _write_m4a

SR = 16000


def pcm(n=4000, seed=0, channels=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.stack([0.4 * np.sin(2 * np.pi * (220 + 55 * c) * t)
                  + 0.02 * rng.standard_normal(n) for c in range(channels)],
                 axis=-1)
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int64)


ENCODINGS = {
    'verbatim': dict(strategy='verbatim'),
    'fixed': dict(strategy='fixed', block_size=1000),
    'lpc': dict(strategy='lpc', block_size=1152),
    'wasted': dict(strategy='wasted'),
    'escape': dict(strategy='fixed', force_escape=True),
    'stereo': dict(block_size=512),
    'mid_side': dict(block_size=512, mid_side=True),
}


@pytest.mark.parametrize('name', list(ENCODINGS))
def test_flac_codec_equal_to_jaxs(name):
    stereo = name in ('stereo', 'mid_side')
    x = pcm(4000 + 37, seed=len(name), channels=2 if stereo else 1)
    if name == 'wasted':
        x = (x >> 3) << 3
    x = x if stereo else x[:, 0]
    ours = flac.encode(x, SR, **ENCODINGS[name])
    theirs = jflac.encode(x, SR, **ENCODINGS[name])
    assert ours == theirs
    for stream in (ours, jflac.encode(x, 22050, **ENCODINGS[name])):
        got, want = flac.decode(stream), jflac.decode(stream)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(flac.decode(ours)[0].reshape(x.shape), x)


def test_flac_checks_fail_alike():
    stream = bytearray(flac.encode(pcm()[:, 0], SR))
    stream[len(stream) // 2] ^= 0x5A
    for codec in (flac, jflac):
        with pytest.raises(ValueError):
            codec.decode(bytes(stream))


def test_flac_files_equal(tmp_path):
    audio = (pcm(3000)[:, 0] / 32768.0).astype(np.float32)
    flac.write(str(tmp_path / 'a.flac'), audio, SR)
    jflac.write(str(tmp_path / 'b.flac'), audio, SR)
    assert (hashlib.md5((tmp_path / 'a.flac').read_bytes()).digest()
            == hashlib.md5((tmp_path / 'b.flac').read_bytes()).digest())
    got, rate = flac.read(str(tmp_path / 'b.flac'))
    want, want_rate = jflac.read(str(tmp_path / 'b.flac'))
    assert rate == want_rate == SR
    np.testing.assert_array_equal(got, want)


def write_inputs(tmp_path):
    mono = pcm(4800, seed=1)[:, 0].astype(np.int16)
    stereo = pcm(4800, seed=2, channels=2).astype(np.int16)
    wavfile.write(str(tmp_path / 'mono.wav'), SR, mono)
    wavfile.write(str(tmp_path / 'stereo.wav'), SR, stereo)
    wavfile.write(str(tmp_path / 'float.wav'), SR,
                  (mono / 32768.0).astype(np.float32))
    wavfile.write(str(tmp_path / 'u8.wav'), SR,
                  (mono // 256 + 128).astype(np.uint8))
    jflac.write(str(tmp_path / 'mono.flac'), mono / 32768.0, SR)
    jflac.write(str(tmp_path / 'stereo.flac'), stereo / 32768.0, SR)
    return ['mono.wav', 'stereo.wav', 'float.wav', 'u8.wav', 'mono.flac',
            'stereo.flac']


@pytest.mark.parametrize('rate', [SR, 24000, 8000])
def test_load_audio_equal_to_jaxs(tmp_path, rate):
    for name in write_inputs(tmp_path):
        path = str(tmp_path / name)
        got = audio_io.load_audio(path, rate)
        want = jaudio_io.load_audio(path, rate)
        assert got.dtype == np.float32 and got.ndim == 1, name
        assert got.shape[0] == 4800 * rate // SR, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_m4a_error_without_a_decoder(tmp_path, monkeypatch):
    _write_m4a(str(tmp_path / 'clip.m4a'), 0)
    monkeypatch.setenv('PATH', str(tmp_path))   # no ffmpeg reachable
    errors = []
    for module in (audio_io, jaudio_io):
        with pytest.raises(RuntimeError) as excinfo:
            module.load_audio(str(tmp_path / 'clip.m4a'), SR)
        errors.append(str(excinfo.value))
    assert errors[0] == errors[1]
    for needle in ('soundfile', 'audioread', 'ffmpeg', 'install'):
        assert needle in errors[0]
