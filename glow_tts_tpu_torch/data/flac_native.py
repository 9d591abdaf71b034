"""ctypes wrapper of the native FLAC decoder: the port's own copy of
``native/flac.cpp`` (``glow_tts_tpu_torch/native/flac.cpp``, held equal to
it by ``tests/test_torch_flac_native.py``), with the contract of
``glow_tts_tpu/data/flac_native.py``.

The pure codec (:mod:`glow_tts_tpu_torch.data.flac`) decodes at roughly
real time; the C++ twin decodes the same format two orders of magnitude
faster, CRC-8/16 checked per frame, and :func:`decode` checks the stream's
MD5 from STREAMINFO over the decoded samples, so the integrity checks are
the pure decoder's.  The library is built with ``g++`` (``$CXX`` where
set) at first use, with the flags of ``native/Makefile`` (but
``-fopenmp``, which it does not use), into
``glow_tts_tpu_torch/_build/libflacdec-<hash>.so``, the hash over the
source, the compiler and the flags; concurrent first builds build once
(a lock on the name, a temporary file renamed into place).  A failed build
or load raises with the compiler's message.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from glow_tts_tpu_torch.ops.cuda_build import BUILD_DIR, PACKAGE_DIR

SOURCE = os.path.join(PACKAGE_DIR, 'native', 'flac.cpp')
# native/Makefile's CXXFLAGS and -shared, without -fopenmp: the decoder has
# no OpenMP region, and a compiler without libgomp refuses the flag
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-Wall', '-Wextra', '-shared')

_lib = None
_lock = threading.Lock()


class UnsupportedStream(Exception):
    """Valid FLAC the native decoder declines by design (no declared
    total sample count): callers fall back to the pure codec."""


def compiler() -> str:
    return os.environ.get('CXX') or 'g++'


def library_path() -> str:
    """Where the build of the source as it stands now lives."""
    hashed = hashlib.sha256(' '.join((compiler(), *CXX_FLAGS)).encode())
    with open(SOURCE, 'rb') as f:
        hashed.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'libflacdec-{hashed.hexdigest()[:12]}.so')


def _build(path: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler(), *CXX_FLAGS, '-o', tmp, SOURCE],
                              capture_output=True, text=True)
    except OSError as error:
        os.unlink(tmp)
        raise RuntimeError(f'cannot run the C++ compiler {compiler()!r} '
                           f'to build {SOURCE}: {error}') from error
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'{compiler()} failed on {SOURCE}:\n'
                           f'{proc.stderr[-4000:]}')
    os.replace(tmp, path)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(path[:-3] + '.lock', 'w') as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    _build(path)
        lib = ctypes.CDLL(path)
        lib.flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),   # data
            ctypes.c_int64,                   # size
            ctypes.POINTER(ctypes.c_int32),   # out (NULL: probe)
            ctypes.c_int64,                   # out capacity (elements)
            ctypes.POINTER(ctypes.c_int32),   # meta[4]
            ctypes.c_char_p,                  # err
            ctypes.c_int32,                   # err capacity
        ]
        lib.flac_decode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def decode(data: bytes, verify_md5: bool = True
           ) -> Tuple[np.ndarray, int, int]:
    """FLAC bytes → (samples [T, C] int32, sample_rate, bits_per_sample),
    the contract of :func:`glow_tts_tpu_torch.data.flac.decode`.  Raises
    ``ValueError`` on a malformed stream (a frame's CRC, the stream's MD5)
    and :class:`UnsupportedStream` on one without a declared total sample
    count."""
    lib = _load_library()
    buf = np.frombuffer(data, np.uint8)
    data_p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    meta = np.zeros(4, np.int32)
    meta_p = meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    err = ctypes.create_string_buffer(256)

    total = lib.flac_decode(data_p, len(data), None, 0, meta_p, err, 256)
    if total < 0:
        raise ValueError(err.value.decode(errors='replace'))
    if total == 0:
        raise UnsupportedStream('flac: unknown total sample count (the '
                                'pure codec decodes it)')
    channels = int(meta[0])
    out = np.empty(total * channels, np.int32)
    got = lib.flac_decode(
        data_p, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.shape[0], meta_p, err, 256)
    if got < 0:
        raise ValueError(err.value.decode(errors='replace'))
    samples = out.reshape(int(got), channels)
    sample_rate, bps = int(meta[1]), int(meta[2])

    if verify_md5:
        md5 = _streaminfo_md5(data)
        if md5 is not None and md5 != b'\x00' * 16:
            from glow_tts_tpu_torch.data.flac import _interleave_bytes
            width = (bps + 7) // 8
            digest = hashlib.md5(
                _interleave_bytes(samples.astype(np.int64), width)).digest()
            if digest != md5:
                raise ValueError('flac: decoded stream fails the MD5 check')
    return samples, sample_rate, bps


def _streaminfo_md5(data: bytes) -> Optional[bytes]:
    if data[:4] != b'fLaC':
        return None
    offset = 4
    while offset + 4 <= len(data):
        header = data[offset]
        length = int.from_bytes(data[offset + 1:offset + 4], 'big')
        if header & 0x7F == 0 and length >= 34:
            return data[offset + 4 + 18:offset + 4 + 34]
        offset += 4 + length
        if header & 0x80:
            break
    return None


def read(path: str) -> Tuple[np.ndarray, int]:
    """A flac file → (float32 audio in [-1, 1], sample_rate), the layout of
    :func:`glow_tts_tpu_torch.data.flac.read` and ``soundfile.read``."""
    with open(path, 'rb') as handle:
        samples, sample_rate, bps = decode(handle.read())
    audio = samples.astype(np.float32) / float(1 << (bps - 1))
    if audio.shape[1] == 1:
        audio = audio[:, 0]
    return audio, sample_rate
