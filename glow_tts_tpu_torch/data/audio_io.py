"""Audio decoding through a chain of fallbacks, each optional (the port's
own copy of ``glow_tts_tpu/data/audio_io.py``):

* ``.wav``: scipy, always there;
* ``.flac``: soundfile where it is installed, else the pure codec of
  :mod:`glow_tts_tpu_torch.data.flac`, so flac corpora (LibriTTS) need no
  external package;
* anything else (``.m4a`` AAC, ogg, ...): soundfile → audioread → an
  ``ffmpeg`` subprocess → a loud error that names every decoder tried and
  how to install one.

Every decoder lands on float32; the downmix and the polyphase resampling
happen here, so every path gives the same layout.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np


def _decode_wav(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype.kind == 'i':
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == 'u':
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def _decode_soundfile(path: str) -> Tuple[np.ndarray, int]:
    import soundfile
    data, sr = soundfile.read(path, dtype='float32')
    return data, sr


def _decode_flac(path: str) -> Tuple[np.ndarray, int]:
    from glow_tts_tpu_torch.data import flac
    return flac.read(path)


def _decode_audioread(path: str) -> Tuple[np.ndarray, int]:
    import audioread
    with audioread.audio_open(path) as handle:
        sr = handle.samplerate
        channels = handle.channels
        buffers = [np.frombuffer(buf, np.int16) for buf in handle]
    data = np.concatenate(buffers).astype(np.float32) / 32768.0
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, sr


def _decode_ffmpeg(path: str, sample_rate: int) -> Tuple[np.ndarray, int]:
    """Decode, downmix and resample in one ffmpeg pass (a float32 pipe)."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError('ffmpeg not on PATH')
    result = subprocess.run(
        [ffmpeg, '-v', 'error', '-i', path, '-map', '0:a:0',
         '-ac', '1', '-ar', str(sample_rate), '-f', 'f32le', 'pipe:1'],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False)
    if result.returncode != 0 or not result.stdout:
        raise RuntimeError(
            f'ffmpeg failed on {path}: '
            f'{result.stderr.decode(errors="replace").strip()}')
    return np.frombuffer(result.stdout, np.float32).copy(), sample_rate


def load_audio(path: str, sample_rate: int) -> np.ndarray:
    """Decode any supported file to mono float32 at ``sample_rate``."""
    ext = os.path.splitext(path)[1].upper()
    attempts: List[str] = []
    data: Optional[np.ndarray] = None
    sr = sample_rate

    if ext == '.WAV':
        data, sr = _decode_wav(path)
    elif ext == '.FLAC':
        try:
            data, sr = _decode_soundfile(path)
        except ImportError:
            data, sr = _decode_flac(path)
    else:
        # compressed and container formats (.m4a AAC, .ogg, .mp3, ...)
        for name, decoder in (
                ('soundfile', lambda: _decode_soundfile(path)),
                ('audioread', lambda: _decode_audioread(path)),
                ('ffmpeg', lambda: _decode_ffmpeg(path, sample_rate))):
            try:
                data, sr = decoder()
                break
            except ImportError:
                attempts.append(f'{name} (not installed)')
            except RuntimeError as error:
                attempts.append(f'{name} ({error})')
            except Exception as error:        # decoder-specific failure
                attempts.append(f'{name} ({type(error).__name__}: {error})')
        if data is None:
            raise RuntimeError(
                f'cannot decode {path!r}: no working decoder for '
                f'{ext or "extensionless"} audio.\n'
                f'  tried: {"; ".join(attempts) or "none"}\n'
                f'  fixes: install ffmpeg (apt install ffmpeg), or '
                f'pip install soundfile / audioread.\n'
                f'  (the torch reference uses librosa→audioread for this, '
                f'Audio.py:3-7; VoxCeleb ships .m4a AAC files)')

    if data.ndim > 1:
        data = data.mean(axis=-1)
    if sr != sample_rate:
        from math import gcd
        from scipy.signal import resample_poly
        g = gcd(int(sample_rate), int(sr))
        data = resample_poly(data, sample_rate // g, sr // g)
    return np.ascontiguousarray(data, np.float32)
