"""Inference artifact export (port of ``glow_tts_tpu/utils/plotting.py``,
the NPY tree; the PNG figures are not ported yet)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def export_npy(base_dir: str, label: str, mel: np.ndarray,
               attention: Optional[np.ndarray] = None) -> None:
    """``<base>/NPY/Mel/<label>.npy``, the mel ``[T, M]`` saved transposed
    ``[M, T]`` as the reference saves it, and the attention ``[T_tok, T]``
    under ``<base>/NPY/Attention/``."""
    mel_dir = os.path.join(base_dir, 'NPY', 'Mel')
    os.makedirs(mel_dir, exist_ok=True)
    np.save(os.path.join(mel_dir, f'{label}.npy'),
            np.asarray(mel).T.astype(np.float32))
    if attention is not None:
        attn_dir = os.path.join(base_dir, 'NPY', 'Attention')
        os.makedirs(attn_dir, exist_ok=True)
        np.save(os.path.join(attn_dir, f'{label}.npy'),
                np.asarray(attention).astype(np.float32))
