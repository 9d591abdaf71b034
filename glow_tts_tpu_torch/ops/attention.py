"""Relative-position tables for Shaw-style attention (port of
``glow_tts_tpu/ops/attention.py``).

The port uses the skewed-table formulation, the JAX package's default:
the per-offset table is gathered once into a per-(query, key) table, and
both relative terms become plain einsums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_relative_embedding(embedding: torch.Tensor,
                            length: int) -> torch.Tensor:
    """[N, 2W+1, D] table for offsets -W…W → [N, 2L-1, D] for offsets
    -(L-1)…(L-1): zero beyond the window, centre-sliced when L-1 < W."""
    window = (embedding.shape[1] - 1) // 2
    pad = max(length - 1 - window, 0)
    padded = F.pad(embedding, (0, 0, pad, pad))
    start = max(window - (length - 1), 0)
    return padded[:, start:start + 2 * length - 1]


def skewed_relative_table(rel: torch.Tensor, length: int) -> torch.Tensor:
    """[N, 2L-1, D] → [N, L, L, D]: out[n, i, j] = rel[n, j - i + L - 1].

    A strided view of the table (row i is the window starting at offset
    L-1-i), so the backward sums each entry's gradient in a fixed order:
    the backward of an index gather (``rel[:, idx]``) accumulates in an
    order that varies from run to run, and a resumed run would not repeat
    an uninterrupted one bit for bit."""
    # windows[n, i, d, t] = rel[n, 2L-2-i-t]; t = L-1-j
    windows = rel.flip(1).unfold(1, length, 1)
    return windows.flip(3).transpose(2, 3)
