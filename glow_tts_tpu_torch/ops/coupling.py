"""One flow step of the Glow decoder as one CUDA kernel.

Replaces ``glow_tts_tpu/ops/coupling.py::_make_kernel(flowstep=True)``
(entry ``fused_flow_step``): ActNorm → block-sparse invertible 1×1 →
WaveNet affine coupling, in reverse order on the inverse pass.  The kernel
is ``glow_tts_tpu_torch/csrc/flow_step.cu``; this module holds its plain
PyTorch version (:func:`flow_step_reference`) and the wrapper
(:func:`flow_step`) that picks between them by the tensor's device alone.

What bounds it on an H100: arithmetic.  Per squeezed frame a step costs
about 3.7 MFLOP (4 layers × (k=5 conv 192→384 + 1×1 192→384), plus the
start, end and mixing 1×1s), so one B=32 decode of 1024 mel frames
(512 squeezed, 12 steps) is about 0.72 TFLOP, while its activations are
a few MB per step and its f32 weights about 7 MB (L2 holds them).  The
unfused version writes every ``[B, T, 384]`` intermediate to device
memory and back; the kernel keeps a whole step's activations in shared
memory: one block per (sample, 32-frame tile) loads the tile plus the
WaveNet's receptive-field halo (8 frames each side at k=5, 4 layers),
recomputes the halo instead of exchanging it, and writes only the step's
output.  The math is plain f32 FMA; the big GEMMs' weights are staged
once per block through shared memory.  Tensor cores (TF32, bf16 via
wgmma) are left to later work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# shapes the compiled kernel is specialised for (the shipped config)
KERNEL_SHAPE = {'channels': 160, 'ch': 192, 'n_layers': 4, 'kernel_size': 5}
WEIGHT_KEYS = ('an_logs', 'an_bias', 'mix_t', 'w_start', 'b_start', 'w_in',
               'w_rs', 'b_rs', 'w_end', 'b_end')


def wavenet_stats(x_a: torch.Tensor, mask: torch.Tensor, weights: Weights,
                  cond: torch.Tensor,
                  pitch: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coupling network: start 1×1 → n gated layers → end 1×1.
    ``x_a [B, T, C/2]``; ``cond [n, B, 2ch]`` per-layer bias.  Returns
    ``(mean, logs)``, each ``[B, T, C/2]``."""
    w_in = weights['w_in']
    n, k, ch, _ = w_in.shape
    h = (x_a @ weights['w_start'] + weights['b_start']) * mask
    skip = torch.zeros_like(h)
    for i in range(n):
        conv_w = w_in[i].permute(2, 1, 0)                     # [2ch, ch, k]
        acc = F.conv1d(h.transpose(1, 2), conv_w,
                       padding=(k - 1) // 2).transpose(1, 2)
        acc = acc + cond[i][:, None, :]
        if pitch is not None:
            acc = acc + pitch @ weights['w_pitch'][i]
        gate = torch.tanh(acc[..., :ch]) * torch.sigmoid(acc[..., ch:])
        rs = gate @ weights['w_rs'][i] + weights['b_rs'][i]
        if i < n - 1:
            h = (h + rs[..., :ch]) * mask
        skip = skip + rs[..., ch:]
    out = (skip * mask) @ weights['w_end'] + weights['b_end']
    return out.chunk(2, dim=-1)


def flow_step_reference(x: torch.Tensor, mask: torch.Tensor,
                        weights: Weights, cond: torch.Tensor,
                        reverse: bool = False,
                        pitch: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch flow step, the same function as the kernel.

    ``x [B, T, C]``, ``mask [B, T, 1]``; ``weights`` as
    ``glow_tts_tpu.ops.coupling.fused_flow_step`` takes them
    (``an_logs``/``an_bias [C]``, ``mix_t [C, C]``, ``ld_const`` (forward),
    ``w_start [C/2, ch]``, ``b_start [ch]``, ``w_in [n, k, ch, 2ch]``,
    ``w_rs [n, ch, 2ch]`` with the last layer's res half zero,
    ``b_rs [n, 2ch]``, ``w_end [ch, C]``, ``b_end [C]``).
    Returns ``(z [B, T, C], logdet [B] | None)``."""
    c2 = x.shape[-1] // 2
    an_logs, an_bias = weights['an_logs'], weights['an_bias']
    if reverse:
        x_a, x_b = x[..., :c2], x[..., c2:]
    else:
        y = (an_bias + torch.exp(an_logs) * x) * mask
        y = (y @ weights['mix_t']) * mask
        x_a, x_b = y[..., :c2], y[..., c2:]
    mean, logs = wavenet_stats(x_a, mask, weights, cond, pitch)
    if reverse:
        z_b = (x_b - mean) * torch.exp(-logs) * mask
        y = (torch.cat([x_a, z_b], dim=-1) @ weights['mix_t']) * mask
        return (y - an_bias) * torch.exp(-an_logs) * mask, None
    z_b = (mean + torch.exp(logs) * x_b) * mask
    logdet = ((logs * mask).sum(dim=(1, 2))
              + weights['ld_const'] * mask.sum(dim=(1, 2)))
    return torch.cat([x_a, z_b], dim=-1), logdet


def flow_step(x: torch.Tensor, mask: torch.Tensor, weights: Weights,
              cond: torch.Tensor, reverse: bool = False,
              pitch: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One flow step: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor.  Arguments and result as
    :func:`flow_step_reference`."""
    if x.device.type == 'cpu':
        return flow_step_reference(x, mask, weights, cond, reverse, pitch)
    if x.device.type != 'cuda':
        raise ValueError(f'flow_step: no kernel for device {x.device}')
    if pitch is not None:
        raise NotImplementedError(
            'flow_step: pitch conditioning is not in the CUDA kernel yet')
    if torch.is_grad_enabled() and any(
            tensor.requires_grad for tensor in (x, cond, *weights.values())):
        raise RuntimeError(
            'flow_step: the CUDA kernel has no backward; run it under '
            'torch.no_grad() or on detached tensors, or train through '
            'ops.coupling_grad.flow_stack_train')
    b, t, c = x.shape
    n, k, ch, ch2 = weights['w_in'].shape
    got = {'channels': c, 'ch': ch, 'n_layers': n, 'kernel_size': k}
    if got != KERNEL_SHAPE:
        raise ValueError(f'flow_step kernel is built for {KERNEL_SHAPE}, '
                         f'got {got}')
    shapes = {'an_logs': (c,), 'an_bias': (c,), 'mix_t': (c, c),
              'w_start': (c // 2, ch), 'b_start': (ch,),
              'w_in': (n, k, ch, ch2), 'w_rs': (n, ch, ch2),
              'b_rs': (n, ch2), 'w_end': (ch, c), 'b_end': (c,)}
    if not reverse:
        shapes['ld_const'] = ()
    tensors = {'x': (x, (b, t, c)), 'mask': (mask, (b, t, 1)),
               'cond': (cond, (n, b, ch2)),
               **{key: (weights[key], shape) for key, shape in shapes.items()}}
    for name, (tensor, shape) in tensors.items():
        if (tensor.device != x.device or tensor.dtype != torch.float32
                or tuple(tensor.shape) != shape
                or not tensor.is_contiguous()):
            raise ValueError(
                f'flow_step: {name} must be a contiguous float32 tensor of '
                f'shape {shape} on {x.device}; got {tuple(tensor.shape)} '
                f'{tensor.dtype} on {tensor.device}')

    lib = load_flow_step_library()
    z = torch.empty_like(x)
    ld_part = ld_ptr = part_ptr = None          # NULL: unused on reverse
    if not reverse:
        # per-(sample, time tile) partial logdets, summed below: no atomics,
        # so the result does not depend on block order
        n_tiles = -(-t // lib.glow_flow_step_time_tile())
        ld_part = torch.empty((b, n_tiles), device=x.device)
        ld_ptr = weights['ld_const'].data_ptr()
        part_ptr = ld_part.data_ptr()
    inputs = [x, mask, cond] + [weights[key] for key in WEIGHT_KEYS]
    err = lib.glow_flow_step_f32(
        *[p.data_ptr() for p in inputs], ld_ptr, z.data_ptr(), part_ptr,
        b, t, int(reverse), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError('flow_step kernel launch failed: '
                           + lib.glow_cuda_error_string(err).decode())
    flow_step.launches += 1
    return z, (None if ld_part is None else ld_part.sum(dim=1))


flow_step.launches = 0


@functools.cache
def load_flow_step_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, typed."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    lib = load_library('flow_step.cu')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_flow_step_f32.argtypes = ([vp] * (3 + len(WEIGHT_KEYS) + 3)
                                       + [ci, ci, ci, vp])
    lib.glow_flow_step_f32.restype = ci
    lib.glow_flow_step_time_tile.argtypes = []
    lib.glow_flow_step_time_tile.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib
