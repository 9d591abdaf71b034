"""Build a CUDA source of this package into a shared library with a plain
C interface, and load it with ctypes.

The library is compiled with ``nvcc`` for Hopper (``sm_90a``) at first use
and kept in ``glow_tts_tpu_torch/_build/`` under a name that carries a hash
of the source, of the headers beside it (``csrc/*.cuh``) and of the flags,
so an edited source is never served stale.  A build may define macros
(``defines``: GR mode's pitch instantiations are the flow kernels built
with ``GLOW_PITCH``, MiniSpeech's 80 flow channels with
``GLOW_CHANNELS=80``); each set of them is a library of its own.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import List, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home else []
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')


def _flags(defines: Sequence[str]) -> List[str]:
    return [*NVCC_FLAGS, *(f'-D{name}' for name in defines)]


def library_path(source: str, defines: Sequence[str] = ()) -> str:
    """Where the build of ``csrc/<source>`` with ``defines`` as it stands
    now lives."""
    src_path = os.path.join(PACKAGE_DIR, 'csrc', source)
    hashed = hashlib.sha256(' '.join(_flags(defines)).encode())
    headers = sorted(glob.glob(os.path.join(PACKAGE_DIR, 'csrc', '*.cuh')))
    for path in [src_path, *headers]:
        with open(path, 'rb') as f:
            hashed.update(f.read())
    stem = '-'.join([os.path.splitext(source)[0],
                     *(name.lower().replace('=', '') for name in defines)])
    return os.path.join(BUILD_DIR,
                        f'lib{stem}-{hashed.hexdigest()[:12]}.so')


def load_library(source: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` unless a build of the same content
    exists, and load it.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is written beside the library as
    ``.log``.  Concurrent first builds are safe and build once: the
    processes of a data-parallel run (and threads) take a lock on the
    library's name, the first compiles to a temporary file and renames it
    into place, and the others find it there."""
    lib_path = library_path(source, defines)
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(lib_path[:-3] + '.lock', 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(lib_path):
                _build(source, defines, lib_path)
    return ctypes.CDLL(lib_path)


def _build(source: str, defines: Sequence[str], lib_path: str) -> None:
    src_path = os.path.join(PACKAGE_DIR, 'csrc', source)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc_path(), *_flags(defines), '-o', tmp,
                           src_path],
                          capture_output=True, text=True)
    with open(lib_path[:-3] + '.log', 'w') as log:
        log.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f'nvcc failed on {source}:\n{proc.stderr[-4000:]}')
    os.replace(tmp, lib_path)


def ptxas_report(source: str, defines: Sequence[str] = ()) -> List[str]:
    """One line per kernel of a built ``csrc/<source>`` (with
    ``defines``): its (mangled) name without the file's prefix, then
    registers, barriers, shared memory and spills as ``ptxas -v`` printed
    them into the build's ``.log``."""
    label = ' '.join([source, *(f'-D{name}' for name in defines)])
    with open(library_path(source, defines)[:-3] + '.log',
              encoding='utf-8') as f:
        text = f.read()
    lines, name, spills = [], '?', ''
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            mangled = re.search(r"'(\w+)'", line).group(1)
            name = re.sub(r'^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}', '',
                          mangled)[:80]
        elif 'spill' in line:
            spills = line.strip()
        elif 'Used' in line:
            used = line.split(':', 1)[1].strip()
            lines.append(f'{label} {name}: {used}; {spills}')
    return lines
