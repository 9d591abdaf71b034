"""Monotonic alignment search (MAS) as two CUDA kernels.

Replaces ``glow_tts_tpu/ops/mas.py::_mas_kernel`` (entry
``maximum_path_pallas``): the Viterbi recurrence over mel frames

    value[x, y] = max(stay, move) + log_p[x, y]
    stay = value[x, y-1]    (illegal when x == y)
    move = value[x-1, y-1]  (x == 0: 0 at y == 0, else illegal)

with one direction bit per cell, then the walk back from
``(token_length - 1, mel_length - 1)`` to frame 0, which marks one token
per valid frame.  The kernels are ``glow_tts_tpu_torch/csrc/mas.cu``: the
recurrence and the walk give the token of each frame, and a second kernel
expands those tokens into the dense path.  This module holds their plain
PyTorch versions (:func:`maximum_path_index_reference` and
:func:`expand_path_reference`, composed in :func:`maximum_path_reference`),
a plain twin of the kernel's windowed walk over packed direction words
(:func:`pack_directions`, :func:`walk_windows_reference`), and the wrapper
(:func:`maximum_path`) that picks between kernel and plain version by the
tensor's device alone.

What bounds it on an H100: by the count, bytes (the valid part of
``log_p`` read once, the path written once, a handful of operations per
cell).  In practice the serial depth does: ``T_mel`` dependent steps per
sample, one block per sample.  The recurrence runs as a wavefront of warps
(a few consecutive tokens per lane, a shuffle to the neighbour lane), each
lane keeps its direction bits in a register word per token and 32 frames
and stores them to an L2-resident scratch (so no frame limit), the walk
steps over register windows of 32 frames, and the path's bytes are written
by a grid that fills the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG = -1.0e9      # "illegal transition" score, as the JAX package's _NEG
MAX_TOKENS = 1024  # the kernel's token capacity (8 warps × 32 lanes × 4)


def mas_directions(log_p: torch.Tensor) -> torch.Tensor:
    """The recurrence: a loop over mel frames that carries one value
    column ``[B, T_tok]``, as ``glow_tts_tpu.ops.mas.maximum_path_scan``
    does.  Returns each cell's direction bit ("came from token x-1", on
    the column before the update) as bool ``[B, T_tok, T_mel]``."""
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
        # rows x == 0 are guarded in the walk
        directions[y] = (x_idx == y) | (v < shifted)
        v = torch.maximum(stay, move) + lp[y]
    return directions.permute(1, 2, 0)


def walk_reference(directions: torch.Tensor, token_lengths: torch.Tensor,
                   mel_lengths: torch.Tensor) -> torch.Tensor:
    """The walk back over direction bits ``[B, T_tok, T_mel]``, from
    ``(token_length - 1, mel_length - 1)``: the token of each frame as
    int32 ``[B, T_mel]``, -1 where the path has none (frames from
    ``mel_length`` on, and every frame of a sample whose last token lies
    outside ``[0, T_tok)``)."""
    b, t_tok, t_mel = directions.shape
    device = directions.device
    rows = torch.arange(b, device=device)
    index = token_lengths.to(device=device, dtype=torch.long) - 1
    mel_lengths = mel_lengths.to(device)
    out = torch.full((b, t_mel), -1, dtype=torch.int32, device=device)
    for y in range(t_mel - 1, -1, -1):
        active = y < mel_lengths                             # [B]
        on = active & (index >= 0) & (index < t_tok)
        out[:, y] = torch.where(on, index, -1).int()
        dir_at = directions[rows, index.clamp(0, t_tok - 1), y] & on
        index = index - (active & (index > 0) & dir_at).long()
    return out


def maximum_path_index_reference(log_p: torch.Tensor,
                                 token_lengths: torch.Tensor,
                                 mel_lengths: torch.Tensor) -> torch.Tensor:
    """Plain twin of the first kernel: the token each frame is aligned to,
    int32 ``[B, T_mel]`` (-1 where none)."""
    return walk_reference(mas_directions(log_p), token_lengths, mel_lengths)


def expand_path_reference(index: torch.Tensor, t_tok: int) -> torch.Tensor:
    """Plain twin of the second kernel: ``path[b, x, y] = (index[b, y] ==
    x)`` as float32 ``[B, t_tok, T_mel]``."""
    x_idx = torch.arange(t_tok, device=index.device)[None, :, None]
    return (x_idx == index[:, None, :]).float()


def maximum_path_reference(log_p: torch.Tensor, token_lengths: torch.Tensor,
                           mel_lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MAS, the same function as the kernels and a twin of
    ``glow_tts_tpu.ops.mas.maximum_path_scan``.

    ``log_p [B, T_tok, T_mel]`` (already masked); lengths ``[B]`` integer.
    Returns the path ``[B, T_tok, T_mel]`` float32 in {0, 1}."""
    index = maximum_path_index_reference(log_p, token_lengths, mel_lengths)
    return expand_path_reference(index, log_p.shape[1])


def pack_directions(directions: torch.Tensor) -> torch.Tensor:
    """Direction bits ``[B, T_tok, T_mel]`` as the first kernel stores them:
    32 frames to a word, bit f of word ``[b, c, t]`` for token t at frame
    32c + f (0 past T_mel), int64 ``[B, ceil(T_mel / 32), T_tok]`` holding
    values in [0, 2**32)."""
    b, t_tok, t_mel = directions.shape
    n_chunks = -(-t_mel // 32)
    padded = torch.zeros((b, t_tok, 32 * n_chunks), dtype=torch.long)
    padded[..., :t_mel] = directions.long()
    weights = 1 << torch.arange(32, dtype=torch.long)
    words = (padded.view(b, t_tok, n_chunks, 32) * weights).sum(dim=3)
    return words.permute(0, 2, 1).contiguous()


def walk_windows_reference(words: torch.Tensor, token_lengths: torch.Tensor,
                           mel_lengths: torch.Tensor, t_mel: int
                           ) -> torch.Tensor:
    """The first kernel's walk, step for step, on packed direction words
    (see :func:`pack_directions`): one word of 32 frames a window, from the
    last valid frame's down.  At a window entered at token ``index``, lane
    r holds the word of token ``index - r`` (0 for token 0, which never
    steps down, and below it); 32 ballots turn those into one word per
    frame (bit r: token ``index - r``), and the window's drops are carried
    in ``m = 1 << drops`` by ``m += bits & m``, frame by frame.  In 32
    frames the token drops by at most 32, so the next window's words are
    among those of tokens ``index - 63 .. index`` of the window before,
    which the kernel loads a window ahead.  Returns what
    :func:`walk_reference` returns."""
    b, _, t_tok = words.shape
    out = torch.full((b, t_mel), -1, dtype=torch.int32)
    for s in range(b):
        tl = int(token_lengths[s])
        ml = min(max(int(mel_lengths[s]), 0), t_mel)
        if not (1 <= tl <= t_tok and ml >= 1):
            continue
        table = words[s].tolist()

        def word(c, t):
            return table[c][t] if c >= 0 and t >= 1 else 0

        index, c = tl - 1, (ml - 1) // 32
        # frames past the last valid one masked off in its window
        lanes = [word(c, index - r) & ((2 << (ml - 1) % 32) - 1)
                 for r in range(32)]
        while c >= 0:
            frame_bits = [sum(((lanes[r] >> f) & 1) << r for r in range(32))
                          for f in range(32)]
            m = 1
            for f in range(31, -1, -1):
                if 32 * c + f < ml:
                    out[s, 32 * c + f] = index - (m.bit_length() - 1)
                m += frame_bits[f] & m
            index -= m.bit_length() - 1
            c -= 1
            lanes = [word(c, index - r) for r in range(32)]
    return out


def _check(log_p, token_lengths, mel_lengths):
    """Raise on what the kernels do not take."""
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


def _launch(log_p, token_lengths, mel_lengths, stamps=None):
    """Both kernels on the current stream; the path (every element
    written).  ``stamps``: the timed instantiation's buffer, or None."""
    lib = load_mas_library()
    b, t_tok, t_mel = log_p.shape
    path = torch.empty_like(log_p)
    dirs = torch.empty((b, -(-t_mel // lib.glow_mas_chunk_frames()), t_tok),
                       dtype=torch.int32, device=log_p.device)
    index = torch.empty((b, t_mel), dtype=torch.int32, device=log_p.device)
    launched = ctypes.c_int(0)
    err = lib.glow_mas_f32(
        log_p.data_ptr(), token_lengths.data_ptr(), mel_lengths.data_ptr(),
        path.data_ptr(), dirs.data_ptr(), index.data_ptr(), b, t_tok, t_mel,
        torch.cuda.current_stream(log_p.device).cuda_stream,
        None if stamps is None else stamps.data_ptr(), ctypes.byref(launched))
    if err != 0:
        raise RuntimeError('maximum_path kernel launch failed: '
                           + lib.glow_cuda_error_string(err).decode())
    return path, launched.value


def maximum_path(log_p: torch.Tensor, token_lengths: torch.Tensor,
                 mel_lengths: torch.Tensor) -> torch.Tensor:
    """MAS: the CUDA kernels for a CUDA tensor, the plain version for a CPU
    tensor.  Arguments and result as :func:`maximum_path_reference`."""
    if log_p.device.type == 'cpu':
        return maximum_path_reference(log_p, token_lengths, mel_lengths)
    _check(log_p, token_lengths, mel_lengths)
    path, kernels = _launch(log_p, token_lengths, mel_lengths)
    maximum_path.launches += 1
    maximum_path.kernels += kernels
    return path


# calls that launched (one each), and the kernels the library launched for
# them (the recurrence and the expansion: two a call)
maximum_path.launches = 0
maximum_path.kernels = 0


def maximum_path_timed(log_p: torch.Tensor, token_lengths: torch.Tensor,
                       mel_lengths: torch.Tensor):
    """The kernels' timed instantiation (CUDA tensors only, checked as by
    :func:`maximum_path`, not counted): the path, and for the sample with
    the most mel frames its phases in ns from the block's start (the
    recurrence ends at the block's barrier, after the last warp), warp 0's
    cycles a frame of the recurrence, the last warp's cycles waiting on its
    ring, and the SM clock they imply."""
    _check(log_p, token_lengths, mel_lengths)
    b = log_p.shape[0]
    n = load_mas_library().glow_mas_stamps_per_sample()
    stamps = torch.zeros((b + 1, n), dtype=torch.int64, device=log_p.device)
    stamps[b, 0] = torch.iinfo(torch.int64).max
    path, _ = _launch(log_p, token_lengths, mel_lengths, stamps)
    torch.cuda.synchronize(log_p.device)
    rows = stamps.tolist()
    (start, fill_end, _, recurrence_end, walk_end, cycles, warp0_end,
     waited) = rows[int(mel_lengths.argmax())][:8]
    frames = int(mel_lengths.max())
    walked = max(max(row[3], row[4]) for row in rows[:b])
    expand_start, expand_end = rows[b][:2]
    return path, {
        'frames': frames,
        'phases_ns': {
            'fill (the last warp waits for its first frames)':
                fill_end - start,
            'warp 0 ends its frames': warp0_end - start,
            'recurrence (the last warp ends)': recurrence_end - start,
            'walk': walk_end - recurrence_end,
            'gap to the expansion kernel': expand_start - walked,
            'path expansion': expand_end - expand_start,
            'total': expand_end - min(row[0] for row in rows[:b])},
        'cycles_a_frame': cycles / frames,
        'last_warp_wait_cycles': waited,
        'sm_ghz': cycles / max(warp0_end - start, 1)}


@functools.cache
def load_mas_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library, typed."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    lib = load_library('mas.cu')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_mas_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                 ctypes.POINTER(ci)]
    lib.glow_mas_f32.restype = ci
    for name in ('glow_mas_stamps_per_sample', 'glow_mas_chunk_frames'):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib
