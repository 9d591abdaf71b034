"""Counter-hash dropout masks of the train-direction flow kernels, in
plain PyTorch (port of ``glow_tts_tpu/ops/dropmask.py``; the device twin
is ``csrc/dropmask.cuh``).

The WaveNet of a coupling drops its in-conv output (conv + bias, before
the conditioning adds), and the backward pass must see the identical
mask.  No mask is stored: it is a pure integer function of

    (seed, flow step, WaveNet layer, sample·r + τ, channel)

with ``r = T + k − 1`` rows per sample, so any tiling of time or batch
regenerates the same bits.  The hash is lowbias32 applied twice; an
element is kept iff ``bits <= round(keep·2³² − 1)`` and scaled by
``1/(1 − rate)`` in float32.

PyTorch has no wrapping uint32 multiply, so the arithmetic runs in int64
and is cut to 32 bits after every multiply and add.  Every function here
takes Python ints as well as int64 tensors.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

IntLike = Union[int, torch.Tensor]
U32 = 0xFFFFFFFF


def hash_u32(x: IntLike) -> IntLike:
    """lowbias32 on values already in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & U32
    x = x ^ (x >> 16)
    return x


def layer_salt(seed: int, step: int, layer: int, num_layers: int) -> int:
    """The uint32 salt of one (flow step, WaveNet layer).  ``seed`` is an
    int32 read as uint32, so a negative seed wraps."""
    sid = (int(step) * num_layers + layer) & U32
    return hash_u32((int(seed) & U32) ^ ((sid * 0x9E3779B9) & U32))


def keep_threshold(rate: float) -> int:
    """Keep iff ``bits <= threshold``; clamped to [0, 2³² − 1], so a rate
    within 2⁻³² of 1 keeps one value in 2³² instead of going negative."""
    keep_prob = 1.0 - float(rate)
    return min(max(int(round(keep_prob * float(2 ** 32) - 1)), 0), U32)


def keep_scale_value(rate: float) -> float:
    """``1/(1 − rate)`` rounded to float32, the kept elements' factor."""
    return float(np.float32(1.0 / (1.0 - float(rate))))


def _mask(rows: torch.Tensor, cols_dim: int, n_cols: int, salt: int,
          rate: float) -> torch.Tensor:
    """{0, 1/(1−rate)} for the global rows ``rows`` (any shape) × the
    first ``n_cols`` of ``cols_dim`` channels."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=rows.device)
    elem = ((rows[..., None] & U32) * cols_dim + cols) & U32
    bits = hash_u32(hash_u32((elem + salt) & U32))
    scale = torch.full((), keep_scale_value(rate), device=rows.device)
    return torch.where(bits <= keep_threshold(rate), scale,
                       torch.zeros((), device=rows.device))


def keep_scale(salt: int, row0: int, shape: Tuple[int, int], cols_dim: int,
               rate: float, device=None) -> torch.Tensor:
    """Mask of {0, 1/(1−rate)} (float32) for the rows ``row0 … row0 +
    shape[0]`` × ``shape[1]`` channels; rows are global (``sample·r + τ``)
    and ``cols_dim`` is the channel count the counters are laid out over."""
    rows = torch.arange(shape[0], dtype=torch.int64, device=device) + row0
    return _mask(rows, cols_dim, shape[1], salt, rate)


def stack_mask(seed: int, step: int, layer: int, num_layers: int, batch: int,
               frames: int, kernel_size: int, cols: int, rate: float,
               device=None) -> torch.Tensor:
    """The mask ``[B, T, cols]`` of one WaveNet layer of one flow step, as
    the kernels draw it: sample ``b``, frame ``τ`` is row
    ``b·(T + k − 1) + τ``."""
    rows_per_sample = frames + kernel_size - 1
    rows = (torch.arange(batch, dtype=torch.int64, device=device)[:, None]
            * rows_per_sample
            + torch.arange(frames, dtype=torch.int64, device=device)[None, :])
    return _mask(rows, cols, cols,
                 layer_salt(seed, step, layer, num_layers), rate)


def true_columns(ch: int, ch_pad: int, device=None) -> torch.Tensor:
    """int64 ``[2·ch_pad]``: the column of the true pre-gate sum ``[2ch]``
    whose dropout bit each column of a WaveNet padded to ``ch_pad`` draws
    (two halves ``ch_pad`` wide): ``j`` in the tanh half, ``j − (ch_pad −
    ch)`` in the sigmoid half; a padded column (zero before and after the
    dropout) draws whatever its counter gives.  The Python twin of
    ``csrc/flow_train_fwd.cu::true_column``."""
    cols = torch.arange(2 * ch_pad, dtype=torch.int64, device=device)
    return torch.where(cols < ch_pad, cols, cols - (ch_pad - ch))


def padded_stack_mask(seed: int, step: int, layer: int, num_layers: int,
                      batch: int, frames: int, kernel_size: int, ch: int,
                      ch_pad: int, rate: float, device=None) -> torch.Tensor:
    """The mask ``[B, T, 2·ch_pad]`` the train forward kernel draws over a
    WaveNet of ``ch`` channels that its body computes at ``ch_pad``: the
    counters of :func:`stack_mask` over the true ``2ch``, at each padded
    column's :func:`true_columns`.  At its true columns it is
    :func:`stack_mask`'s ``[B, T, 2ch]``."""
    rows_per_sample = frames + kernel_size - 1
    rows = (torch.arange(batch, dtype=torch.int64, device=device)[:, None]
            * rows_per_sample
            + torch.arange(frames, dtype=torch.int64, device=device)[None, :])
    elem = ((rows[..., None] & U32) * (2 * ch)
            + true_columns(ch, ch_pad, device)) & U32
    salt = layer_salt(seed, step, layer, num_layers)
    bits = hash_u32(hash_u32((elem + salt) & U32))
    scale = torch.full((), keep_scale_value(rate), device=device)
    return torch.where(bits <= keep_threshold(rate), scale,
                       torch.zeros((), device=device))
