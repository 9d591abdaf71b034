"""Inference artifact export (port of ``glow_tts_tpu/utils/plotting.py``):
the NPY tree and a PNG figure per utterance.

The figures need matplotlib; where it does not import, :func:`figures`
says so once per process and the callers skip the PNGs, writing the rest
(the NPY and WAV trees, the summaries) as they would."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from glow_tts_tpu_torch.utils.logging import logger

_MISSING = []


def figures() -> bool:
    """Whether matplotlib imports (with the non-interactive Agg backend
    selected); the first time it does not, one warning names it."""
    if _MISSING:
        return False
    try:
        import matplotlib
    except ImportError as error:
        _MISSING.append(error)
        logger.warning('matplotlib does not import (%s): the PNG figures '
                       'and image summaries are skipped; NPY, WAV, scalars, '
                       'histograms and embeddings are still written', error)
        return False
    matplotlib.use('Agg')
    return True


def export_mel_figure(path: str, mel: np.ndarray,
                      attention: Optional[np.ndarray] = None,
                      title: str = '') -> None:
    """``mel [T, M]`` plotted transposed (the mel bins vertical), and the
    ``attention [T_tok, T]`` below it, as the JAX package draws them."""
    if not figures():
        return
    import matplotlib.pyplot as plt
    rows = 2 if attention is not None else 1
    fig = plt.figure(figsize=(12, 4 * rows))
    plt.subplot(rows, 1, 1)
    plt.imshow(np.asarray(mel).T, aspect='auto', origin='lower')
    plt.title(f'Mel  {title}')
    plt.colorbar()
    if attention is not None:
        plt.subplot(rows, 1, 2)
        plt.imshow(np.asarray(attention), aspect='auto', origin='lower')
        plt.title('Attention')
        plt.colorbar()
    plt.tight_layout()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


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
