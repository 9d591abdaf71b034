"""Monotonic alignment search (MAS) as one CUDA kernel.

Replaces ``glow_tts_tpu/ops/mas.py::_mas_kernel`` (entry
``maximum_path_pallas``): the Viterbi recurrence over mel frames

    value[x, y] = max(stay, move) + log_p[x, y]
    stay = value[x, y-1]    (illegal when x == y)
    move = value[x-1, y-1]  (x == 0: 0 at y == 0, else illegal)

with one direction bit per cell, then the walk back from
``(token_length - 1, mel_length - 1)`` to frame 0, which marks one token
per valid frame.  The kernel is ``glow_tts_tpu_torch/csrc/mas.cu``; this
module holds its plain PyTorch version (:func:`maximum_path_reference`)
and the wrapper (:func:`maximum_path`) that picks between them by the
tensor's device alone.

What bounds it on an H100: by the count, bytes (``log_p`` read once, the
path written once, a handful of operations per cell).  In practice the
serial depth does: ``T_mel`` dependent steps per sample, and a batch of 32
fills 32 of the card's 132 SMs.  The kernel therefore keeps the dependent
chain short: one warp per sample carries the value column in registers
(the ``x-1`` neighbour is a register or one shuffle), the other warps of
the block stream ``log_p`` into shared memory ahead of it, and the
direction bits stay in shared memory until the walk.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG = -1.0e9      # "illegal transition" score, as the JAX package's _NEG
MAX_TOKENS = 1024  # the kernel's token capacity (32 lanes × 32 tokens)


def maximum_path_reference(log_p: torch.Tensor, token_lengths: torch.Tensor,
                           mel_lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MAS, the same function as the kernel and a twin of
    ``glow_tts_tpu.ops.mas.maximum_path_scan``: a loop over mel frames that
    carries one value column ``[B, T_tok]`` and keeps each frame's direction
    bits, then the reverse walk.

    ``log_p [B, T_tok, T_mel]`` (already masked); lengths ``[B]`` integer.
    Returns the path ``[B, T_tok, T_mel]`` float32 in {0, 1}."""
    b, t_tok, t_mel = log_p.shape
    device = log_p.device
    lp = log_p.float().permute(2, 0, 1)                      # [T_mel, B, T_tok]
    x_idx = torch.arange(t_tok, device=device)[None, :]
    neg = torch.full((b, 1), NEG, device=device)
    first_move = {True: torch.zeros((), device=device),
                  False: torch.full((), NEG, device=device)}

    v = torch.full((b, t_tok), NEG, device=device)
    directions = torch.empty((t_mel, b, t_tok), dtype=torch.bool,
                             device=device)
    for y in range(t_mel):
        shifted = torch.cat([neg, v[:, :-1]], dim=1)
        stay = torch.where(x_idx == y, neg, v)
        move = torch.where(x_idx == 0, first_move[y == 0], shifted)
        # "came from token x-1", on the raw column: rows x == 0 are guarded
        # in the walk
        directions[y] = (x_idx == y) | (v < shifted)
        v = torch.maximum(stay, move) + lp[y]

    index = token_lengths.to(device=device, dtype=torch.long) - 1
    mel_lengths = mel_lengths.to(device)
    path = torch.zeros((t_mel, b, t_tok), device=device)
    for y in range(t_mel - 1, -1, -1):
        active = y < mel_lengths                             # [B]
        onehot = (x_idx == index[:, None]) & active[:, None]
        path[y] = onehot
        dir_at = (onehot & directions[y]).any(dim=1)
        index = index - (active & (index > 0) & dir_at).long()
    return path.permute(1, 2, 0).contiguous()


def maximum_path(log_p: torch.Tensor, token_lengths: torch.Tensor,
                 mel_lengths: torch.Tensor) -> torch.Tensor:
    """MAS: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor.  Arguments and result as :func:`maximum_path_reference`."""
    if log_p.device.type == 'cpu':
        return maximum_path_reference(log_p, token_lengths, mel_lengths)
    if log_p.device.type != 'cuda':
        raise ValueError(f'maximum_path: no kernel for device {log_p.device}')
    if log_p.dim() != 3:
        raise ValueError(f'maximum_path: log_p must be [B, T_tok, T_mel], '
                         f'got {tuple(log_p.shape)}')
    b, t_tok, t_mel = log_p.shape
    if log_p.dtype != torch.float32 or not log_p.is_contiguous():
        raise ValueError(
            f'maximum_path: log_p must be a contiguous float32 tensor; got '
            f'{log_p.dtype}, contiguous={log_p.is_contiguous()}')
    for name, lengths in (('token_lengths', token_lengths),
                          ('mel_lengths', mel_lengths)):
        if (lengths.device != log_p.device or tuple(lengths.shape) != (b,)
                or lengths.dtype != torch.int32
                or not lengths.is_contiguous()):
            raise ValueError(
                f'maximum_path: {name} must be a contiguous int32 tensor of '
                f'shape ({b},) on {log_p.device}; got '
                f'{tuple(lengths.shape)} {lengths.dtype} on {lengths.device}')
    if min(b, t_tok, t_mel) == 0:
        raise ValueError(f'maximum_path: empty log_p {tuple(log_p.shape)}')

    if t_tok > MAX_TOKENS:
        raise ValueError(f'maximum_path kernel takes at most {MAX_TOKENS} '
                         f'tokens, got {t_tok}')
    lib = load_mas_library()
    max_mel = lib.glow_mas_max_mel_frames(t_tok)
    if t_mel > max_mel:
        raise ValueError(
            f'maximum_path kernel keeps the direction bits in shared memory: '
            f'at {t_tok} tokens it takes at most {max_mel} mel frames, '
            f'got {t_mel}')
    path = torch.empty_like(log_p)        # the kernel writes every element
    err = lib.glow_mas_f32(
        log_p.data_ptr(), token_lengths.data_ptr(), mel_lengths.data_ptr(),
        path.data_ptr(), b, t_tok, t_mel,
        torch.cuda.current_stream(log_p.device).cuda_stream)
    if err != 0:
        raise RuntimeError('maximum_path kernel launch failed: '
                           + lib.glow_cuda_error_string(err).decode())
    maximum_path.launches += 1
    return path


maximum_path.launches = 0


@functools.cache
def load_mas_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, typed."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    lib = load_library('mas.cu')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_mas_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.glow_mas_f32.restype = ci
    lib.glow_mas_max_mel_frames.argtypes = [ci]
    lib.glow_mas_max_mel_frames.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib
