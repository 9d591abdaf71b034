"""The PyTorch port's native FLAC decoder (``glow_tts_tpu_torch/data/
flac_native.py`` over its own copy of ``native/flac.cpp``) against the
port's pure codec and the JAX package's native decoder, bit for bit, on
the streams of ``tests/test_flac_native.py`` (the four subframe
strategies, escape partitions, a constant subframe, stereo with and
without mid-side, a partial final block, a fuzz of shapes), which the
port's encoder writes; corruption and an MD5 mismatch raise; a stream
without a declared total falls back to the pure codec; ``load_audio``
routes ``.flac`` through the native decoder where soundfile is absent;
the library is built into ``glow_tts_tpu_torch/_build/`` under a hashed
name, and a broken build raises with the compiler's message.
"""

import os

import numpy as np
import pytest

from glow_tts_tpu.data import flac_native as jax_flac_native
from glow_tts_tpu_torch.data import audio_io, flac, flac_native
from glow_tts_tpu_torch.ops.cuda_build import BUILD_DIR, PACKAGE_DIR

REPO = os.path.dirname(PACKAGE_DIR)


def _signal(n=6400, seed=0, amplitude=0.4):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(n)) * 500 + rng.standard_normal(n) * 600
    return np.clip(x, -32000 * amplitude, 32000 * amplitude).astype(np.int64)


def _assert_match(data: bytes):
    """Native, pure and the JAX package's native decode agree bit for
    bit, with the rate and the sample width."""
    ref, sr_r, bps_r = flac.decode(data)
    for decoder in (flac_native.decode, jax_flac_native.decode):
        got, sr_g, bps_g = decoder(data)
        assert (sr_g, bps_g) == (sr_r, bps_r)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(ref))


def _without_total(data: bytes) -> bytes:
    """``data`` with STREAMINFO's 36-bit total sample count zeroed (the
    low 36 bits of the 8 bytes after the frame sizes)."""
    out = bytearray(data)
    out[8 + 13] &= 0xF0
    out[8 + 14:8 + 18] = b'\x00' * 4
    return bytes(out)


def test_the_copy_equals_native_flac_cpp():
    with open(os.path.join(REPO, 'native', 'flac.cpp'), 'rb') as f:
        original = f.read()
    with open(flac_native.SOURCE, 'rb') as f:
        assert f.read() == original
    assert flac_native.SOURCE == os.path.join(PACKAGE_DIR, 'native',
                                              'flac.cpp')


def test_the_library_is_built_under_build_by_hash():
    flac_native.decode(flac.encode(_signal(600), 8000))
    path = flac_native.library_path()
    assert os.path.dirname(path) == BUILD_DIR
    name = os.path.basename(path)
    assert name.startswith('libflacdec-') and name.endswith('.so')
    assert len(name) == len('libflacdec-.so') + 12
    assert os.path.exists(path)
    assert flac_native._load_library()._name == path


@pytest.mark.parametrize('strategy', ['verbatim', 'fixed', 'lpc', 'wasted'])
def test_mono_matches(strategy):
    _assert_match(flac.encode(_signal(), 24000, strategy=strategy))


def test_escape_partition_matches():
    _assert_match(flac.encode(_signal(seed=3), 16000, strategy='fixed',
                              force_escape=True))


def test_constant_subframe_matches():
    _assert_match(flac.encode(np.full(1200, -7, np.int64), 22050))


@pytest.mark.parametrize('mid_side', [False, True])
def test_stereo_matches(mid_side):
    sig = _signal(4800, seed=5)
    stereo = np.stack([sig, (sig * 0.6).astype(np.int64)], axis=-1)
    _assert_match(flac.encode(stereo, 48000, mid_side=mid_side))


def test_partial_final_block_matches():
    _assert_match(flac.encode(_signal(777, seed=7), 8000, block_size=256))


def test_fuzz_matches():
    rng = np.random.default_rng(98)
    for _ in range(8):
        n = int(rng.integers(64, 3000))
        channels = int(rng.integers(1, 3))
        sig = np.clip(np.cumsum(rng.standard_normal((n, channels)), axis=0)
                      * rng.uniform(10, 2000)
                      + rng.standard_normal((n, channels)) * 300,
                      -32000, 32000).astype(np.int64)
        if channels == 1:
            sig = sig[:, 0]
        kwargs = dict(
            strategy=str(rng.choice(['verbatim', 'fixed', 'lpc', 'wasted'])),
            block_size=int(rng.choice([192, 256, 1024, 4096])),
            force_escape=bool(rng.integers(0, 2)))
        if channels == 2 and rng.integers(0, 2):
            kwargs['mid_side'] = True
        _assert_match(flac.encode(sig, 24000, **kwargs))


def test_corruption_raises():
    data = bytearray(flac.encode(_signal(seed=9), 24000))
    data[len(data) // 2] ^= 0x40
    with pytest.raises(ValueError):
        flac_native.decode(bytes(data))


def test_md5_mismatch_raises():
    data = bytearray(flac.encode(_signal(seed=11), 24000))
    # a bit of STREAMINFO's MD5: every frame passes its CRC, the stream's
    # digest does not
    data[8 + 4 + 20] ^= 0x01
    with pytest.raises(ValueError, match='MD5'):
        flac_native.decode(bytes(data))
    assert flac_native.decode(bytes(data), verify_md5=False)[0].size


def test_read_layout_matches_the_pure_codec(tmp_path):
    path = str(tmp_path / 'x.flac')
    flac.write(path, _signal(2400, seed=13).astype(np.float32) / 32768.0,
               24000)
    a, sr_a = flac.read(path)
    b, sr_b = flac_native.read(path)
    assert sr_a == sr_b
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def no_soundfile(monkeypatch):
    def missing(path):
        raise ImportError('no soundfile')
    monkeypatch.setattr(audio_io, '_decode_soundfile', missing)


def test_load_audio_decodes_flac_natively(tmp_path, monkeypatch,
                                          no_soundfile):
    path = str(tmp_path / 'y.flac')
    sig = _signal(3200, seed=17)
    flac.write(path, sig.astype(np.float32) / 32768.0, 24000)
    calls = []
    real = flac_native.read

    def spy(p):
        calls.append(p)
        return real(p)
    monkeypatch.setattr(flac_native, 'read', spy)
    got = audio_io.load_audio(path, 24000)
    assert calls == [path]
    np.testing.assert_array_equal(got, flac.read(path)[0])


def test_a_stream_without_a_total_falls_back_to_the_pure_codec(
        tmp_path, monkeypatch, no_soundfile):
    data = _without_total(flac.encode(_signal(2000, seed=19), 16000))
    with pytest.raises(flac_native.UnsupportedStream):
        flac_native.decode(data)
    path = str(tmp_path / 'z.flac')
    with open(path, 'wb') as f:
        f.write(data)
    pure = []
    real = flac.read

    def spy(p):
        pure.append(p)
        return real(p)
    monkeypatch.setattr(flac, 'read', spy)
    got = audio_io.load_audio(path, 16000)
    assert pure == [path]
    np.testing.assert_array_equal(
        got, flac.decode(data)[0][:, 0].astype(np.float32) / 32768.0)


def test_a_malformed_stream_raises_through_load_audio(tmp_path,
                                                      no_soundfile):
    data = bytearray(flac.encode(_signal(seed=23), 24000))
    data[len(data) // 2] ^= 0x40
    path = str(tmp_path / 'bad.flac')
    with open(path, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(ValueError):
        audio_io.load_audio(path, 24000)


@pytest.mark.parametrize('broken', ['source', 'compiler'])
def test_a_failed_build_raises(tmp_path, monkeypatch, broken):
    monkeypatch.setattr(flac_native, '_lib', None)
    monkeypatch.setattr(flac_native, 'BUILD_DIR', str(tmp_path / 'build'))
    if broken == 'source':
        source = tmp_path / 'flac.cpp'
        source.write_text('extern "C" int flac_decode( {\n')
        monkeypatch.setattr(flac_native, 'SOURCE', str(source))
        match = 'failed on'
    else:
        monkeypatch.setenv('CXX', str(tmp_path / 'no-such-compiler'))
        match = 'cannot run the C\\+\\+ compiler'
    with pytest.raises(RuntimeError, match=match):
        flac_native.decode(flac.encode(_signal(300), 8000))
    assert not any(name.endswith('.so')
                   for name in os.listdir(tmp_path / 'build'))
