"""The train-direction flow stack: all flow steps forward with dropout
inside the coupling WaveNets, and a hand-written backward pass.

Replaces ``glow_tts_tpu/ops/coupling_grad.py`` (``_make_train_fwd_kernel``
and ``_make_train_bwd_kernel`` behind ``fused_flow_stack_train``).  The
kernels are ``csrc/flow_train_fwd.cu`` and ``csrc/flow_train_bwd.cu``; this
module holds their plain PyTorch version
(:func:`flow_stack_train_reference`, differentiable by autograd, the value
and gradient oracle) and the entry :func:`flow_stack_train`, which picks
between them by the tensor's device alone.

What bounds the pair on an H100: arithmetic.  A step costs 3.7 MFLOP per
squeezed frame forward; the backward pass recomputes the step from its
checkpoint and then does the activation gradients and the weight gradients,
each the forward's work again, so a train step's flow is about four
forwards.  The forward keeps a step's activations in shared memory (the
flow-step kernel's tiling); the backward runs per step as a recompute
launch and a fixed sequence of 34 tiled GEMM and reduction launches over activations left in
device memory (about 190 MB at 32 × 512 frames, reused by every step), with
weight gradients split over frame chunks into partials that are added here
in a fixed order: no atomics, so two runs give the same bits.  The math is
plain f32 FMA; tensor cores are left to later work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from glow_tts_tpu_torch.ops import dropmask
from glow_tts_tpu_torch.ops.coupling import KERNEL_SHAPE

Weights = Dict[str, torch.Tensor]

# stacked [S, ...] weights in the order the forward library takes them;
# ``ld_const [S]`` rides beside them and never enters a kernel
WEIGHT_KEYS = ('an_logs', 'an_bias', 'mix_t', 'w_start', 'b_start', 'w_in',
               'b_in', 'w_rs', 'b_rs', 'w_end', 'b_end')


def weight_shapes(s: int, c: int, ch: int, n: int, k: int
                  ) -> Dict[str, Tuple[int, ...]]:
    return {'an_logs': (s, c), 'an_bias': (s, c), 'mix_t': (s, c, c),
            'w_start': (s, c // 2, ch), 'b_start': (s, ch),
            'w_in': (s, n, k, ch, 2 * ch), 'b_in': (s, n, 2 * ch),
            'w_rs': (s, n, ch, 2 * ch), 'b_rs': (s, n, 2 * ch),
            'w_end': (s, ch, c), 'b_end': (s, c)}


def flow_stack_train_reference(x: torch.Tensor, mask: torch.Tensor,
                               weights: Weights,
                               cond: Optional[torch.Tensor] = None,
                               pitch: Optional[torch.Tensor] = None, *,
                               seed: int, dropout_rate: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch train-direction flow stack, the same function as the
    kernels, differentiable by autograd (twin of
    ``glow_tts_tpu.ops.coupling_grad.flow_stack_train_reference``, with the
    identical hash dropout masks).

    ``x [B, T, C]``, ``mask [B, T, 1]``; ``weights`` stacked over the flow
    steps (:func:`weight_shapes`, plus ``ld_const [S]`` and, with
    ``pitch [B, T, P]``, ``w_pitch [S, n, P, 2ch]``); ``cond [S, n, B,
    2ch]`` holds only what is added after the dropout.  Every step is
    ActNorm → mixing → coupling, whose WaveNet drops ``conv + b_in`` before
    ``cond`` and pitch are added.  Returns ``(z [B, T, C], logdet [B])``."""
    b, t, c = x.shape
    c2 = c // 2
    s_steps, n, k, ch, ch2 = weights['w_in'].shape
    mask = mask.float()
    xc = x.float()
    ld = torch.zeros(b, device=x.device)
    for sj in range(s_steps):
        y = (weights['an_bias'][sj] + torch.exp(weights['an_logs'][sj]) * xc
             ) * mask
        yd = (y @ weights['mix_t'][sj]) * mask
        xa, xb = yd[..., :c2], yd[..., c2:]
        h = (xa @ weights['w_start'][sj] + weights['b_start'][sj]) * mask
        skip = torch.zeros_like(h)
        for i in range(n):
            conv_w = weights['w_in'][sj, i].permute(2, 1, 0)   # [2ch, ch, k]
            acc = F.conv1d(h.transpose(1, 2), conv_w,
                           padding=(k - 1) // 2).transpose(1, 2)
            acc = acc + weights['b_in'][sj, i]
            if dropout_rate > 0.0:
                acc = acc * dropmask.stack_mask(
                    seed, sj, i, n, b, t, k, ch2, dropout_rate, x.device)
            if cond is not None:
                acc = acc + cond[sj, i][:, None, :]
            if pitch is not None:
                acc = acc + pitch @ weights['w_pitch'][sj, i]
            gate = torch.tanh(acc[..., :ch]) * torch.sigmoid(acc[..., ch:])
            rs = gate @ weights['w_rs'][sj, i] + weights['b_rs'][sj, i]
            if i < n - 1:
                h = (h + rs[..., :ch]) * mask
            skip = skip + rs[..., ch:]
        outs = (skip * mask) @ weights['w_end'][sj] + weights['b_end'][sj]
        mean, logs = outs[..., :c2], outs[..., c2:]
        zb = (mean + torch.exp(logs) * xb) * mask
        ld = ld + (logs * mask).sum(dim=(1, 2))
        xc = torch.cat([xa, zb], dim=-1)
    ld = ld + weights['ld_const'].float().sum() * mask.sum(dim=(1, 2))
    return xc, ld


def _dropout_args(seed: int, rate: float) -> Tuple[int, int, float, int]:
    """(seed as int32, threshold, scale, enabled) as the libraries take
    them."""
    seed = ((int(seed) + 2 ** 31) % 2 ** 32) - 2 ** 31
    if rate <= 0.0:
        return seed, dropmask.U32, 1.0, 0
    return (seed, dropmask.keep_threshold(rate),
            dropmask.keep_scale_value(rate), 1)


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           + lib.glow_cuda_error_string(err).decode())


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[None if tensor is None else tensor.data_ptr()
          for tensor in tensors])


# what the backward pass recomputes per flow step, over the M = B·T frames
SAVED_KEYS = ('y', 'yd', 'xin', 'ts', 'skip', 'logs')


def _saved_buffers(m: int, c: int, ch: int, n: int,
                   device) -> Dict[str, torch.Tensor]:
    """ActNorm output ``y`` and mixing output ``yd`` ``[M, C]``, every
    layer's input ``xin [n, M, ch]`` and gate halves ``ts [n, M, 2ch]``
    (tanh, sigmoid), the masked skip sum ``[M, ch]``, ``logs [M, C/2]``."""
    shapes = {'y': (m, c), 'yd': (m, c), 'xin': (n, m, ch),
              'ts': (n, m, 2 * ch), 'skip': (m, ch), 'logs': (m, c // 2)}
    return {key: torch.empty(shapes[key], device=device)
            for key in SAVED_KEYS}


def _recompute(x_step, mask, cond, weights, saved, step: int, drop) -> None:
    """One launch of the forward kernel's saving instantiation: flow step
    ``step`` from its input ``x_step [B, T, C]`` into ``saved``."""
    lib = load_train_forward_library()
    b, t, _ = x_step.shape
    err = lib.glow_flow_train_fwd_f32(
        x_step.data_ptr(), mask.data_ptr(),
        None if cond is None else cond.data_ptr(),
        *[w.data_ptr() for w in weights], None,
        _pointers([saved[key] for key in SAVED_KEYS]), b, t, step, step + 1,
        *drop, torch.cuda.current_stream(x_step.device).cuda_stream)
    _raise_on(err, lib, 'flow_stack_train recompute')
    flow_stack_train.recompute_launches += 1


class _FlowStackTrain(torch.autograd.Function):
    """The two kernels as one differentiable function of
    ``(x, cond, *weights)``; returns ``(z, WaveNet logdet)``."""

    @staticmethod
    def forward(ctx, x, mask, cond, seed, rate, *weights):
        b, t, c = x.shape
        s_steps = weights[0].shape[0]
        lib = load_train_forward_library()
        acts = torch.empty((s_steps + 1, b, t, c), device=x.device)
        acts[0].copy_(x)
        n_tiles = -(-t // lib.glow_flow_train_time_tile())
        # per-(step, sample, time tile) partial logdets, summed below: no
        # atomics, so the result does not depend on block order
        ld_part = torch.empty((s_steps, b, n_tiles), device=x.device)
        drop = _dropout_args(seed, rate)
        err = lib.glow_flow_train_fwd_f32(
            acts.data_ptr(), mask.data_ptr(),
            None if cond is None else cond.data_ptr(),
            *[w.data_ptr() for w in weights], ld_part.data_ptr(), None,
            b, t, 0, s_steps, *drop,
            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, lib, 'flow_stack_train forward')
        flow_stack_train.forward_launches += s_steps
        ctx.save_for_backward(acts, mask, cond, *weights)
        ctx.drop = drop
        return acts[s_steps], ld_part.sum(dim=(0, 2))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz, dld):
        acts, mask, cond, *weights = ctx.saved_tensors
        named = dict(zip(WEIGHT_KEYS, weights))
        s_steps, b, t, c = acts.shape[0] - 1, *acts.shape[1:]
        _, n, k, ch, ch2 = named['w_in'].shape
        m = b * t
        device = acts.device
        bwd = load_train_backward_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        nsplit = -(-m // bwd.glow_flow_train_bwd_split_rows())

        def empty(*shape):
            return torch.empty(shape, device=device)

        dz = (torch.zeros_like(acts[0]) if dz is None
              else dz.float().contiguous())
        dld = empty(b).zero_() if dld is None else dld.float().contiguous()
        saved = _saved_buffers(m, c, ch, n, device)
        scratch = [empty(m, c), empty(m, ch2), empty(m, ch2),
                   None if cond is None else empty(m, ch2),
                   empty(m, c), empty(m, 2 * c)]
        parts = {'w_end': empty(nsplit, ch, c),
                 'w_rs': empty(n, nsplit, ch, ch2),
                 'w_in': empty(n, nsplit, k * ch, ch2),
                 'w_start': empty(nsplit, c // 2, ch),
                 'mix_t': empty(nsplit, c, c)}
        sums = {'b_end': empty(b, c), 'b_rs': empty(n, b, ch2),
                'b_in': empty(n, b, ch2), 'b_start': empty(b, ch),
                'an': empty(b, 2 * c)}
        grads = {key: torch.empty_like(value) for key, value in named.items()}
        dcond = None if cond is None else torch.empty_like(cond)
        # the cotangent walks down the steps through two buffers of its own
        # (the incoming dz is not written to)
        dx_in, dx_bufs = dz, [torch.empty_like(dz), torch.empty_like(dz)]
        launched = ctypes.c_int(0)
        for s in range(s_steps - 1, -1, -1):
            _recompute(acts[s], mask, cond, weights, saved, s, ctx.drop)
            inputs = [acts[s], *saved.values(), mask, dld, dx_in, named['an_logs'][s],
                      named['mix_t'][s], named['w_start'][s], named['w_in'][s],
                      named['w_rs'][s], named['w_end'][s]]
            outputs = [dx_bufs[s % 2], *scratch, parts['w_end'], parts['w_rs'],
                       parts['w_in'], parts['w_start'], parts['mix_t'],
                       sums['b_end'], sums['b_rs'], sums['b_in'],
                       None if dcond is None else dcond[s],
                       sums['b_start'], sums['an']]
            err = bwd.glow_flow_train_bwd_step_f32(
                _pointers(inputs), _pointers(outputs), b, t, c, ch, n, k, s,
                *ctx.drop, stream, ctypes.byref(launched))
            flow_stack_train.backward_launches += launched.value
            _raise_on(err, bwd, 'flow_stack_train backward')
            # the partials of the frame chunks and of the samples, added in
            # their order
            torch.sum(parts['w_end'], dim=0, out=grads['w_end'][s])
            torch.sum(parts['w_rs'], dim=1, out=grads['w_rs'][s])
            torch.sum(parts['w_in'], dim=1,
                      out=grads['w_in'][s].view(n, k * ch, ch2))
            torch.sum(parts['w_start'], dim=0, out=grads['w_start'][s])
            torch.sum(parts['mix_t'], dim=0, out=grads['mix_t'][s])
            torch.sum(sums['b_end'], dim=0, out=grads['b_end'][s])
            torch.sum(sums['b_rs'], dim=1, out=grads['b_rs'][s])
            torch.sum(sums['b_in'], dim=1, out=grads['b_in'][s])
            torch.sum(sums['b_start'], dim=0, out=grads['b_start'][s])
            dan = sums['an'].sum(dim=0)
            grads['an_bias'][s] = dan[:c]
            grads['an_logs'][s] = dan[c:]
            dx_in = dx_bufs[s % 2]
        return (dx_in, None, dcond, None, None,
                *[grads[key] for key in WEIGHT_KEYS])


def _check_cuda_inputs(x, mask, weights, cond, pitch) -> None:
    """Raise on what the kernels are not built for."""
    if x.device.type != 'cuda':
        raise ValueError(f'flow_stack_train: no kernel for device {x.device}')
    if pitch is not None:
        raise NotImplementedError(
            'flow_stack_train: pitch conditioning is not in the CUDA kernels '
            'yet')
    b, t, c = x.shape
    s_steps, n, k, ch, ch2 = weights['w_in'].shape
    got = {'channels': c, 'ch': ch, 'n_layers': n, 'kernel_size': k}
    if got != KERNEL_SHAPE:
        raise ValueError(f'flow_stack_train kernels are built for '
                         f'{KERNEL_SHAPE}, got {got}')
    tensors = {'x': (x, (b, t, c)), 'mask': (mask, (b, t, 1)),
               'ld_const': (weights['ld_const'], (s_steps,)),
               **{key: (weights[key], shape) for key, shape
                  in weight_shapes(s_steps, c, ch, n, k).items()}}
    if cond is not None:
        tensors['cond'] = (cond, (s_steps, n, b, ch2))
    for name, (tensor, shape) in tensors.items():
        if (tensor.device != x.device or tensor.dtype != torch.float32
                or tuple(tensor.shape) != shape
                or not tensor.is_contiguous()):
            raise ValueError(
                f'flow_stack_train: {name} must be a contiguous float32 '
                f'tensor of shape {shape} on {x.device}; got '
                f'{tuple(tensor.shape)} {tensor.dtype} on {tensor.device}')


def flow_stack_train(x: torch.Tensor, mask: torch.Tensor, weights: Weights,
                     cond: Optional[torch.Tensor] = None,
                     pitch: Optional[torch.Tensor] = None, *, seed: int,
                     dropout_rate: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable train-direction flow stack: the CUDA kernels for
    a CUDA tensor (forward, and backward under autograd), the plain version
    for a CPU tensor.  Arguments and result as
    :func:`flow_stack_train_reference`; ``seed`` is an int32 (fold the step
    counter into it), from which forward and backward draw the same masks.
    The logdet's per-frame constant (``ld_const``) is added here in plain
    PyTorch, so its gradient flows by autograd."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f'dropout_rate must be in [0, 1), got {dropout_rate}')
    if x.device.type == 'cpu':
        return flow_stack_train_reference(x, mask, weights, cond, pitch,
                                          seed=seed,
                                          dropout_rate=dropout_rate)
    _check_cuda_inputs(x, mask, weights, cond, pitch)
    z, ld = _FlowStackTrain.apply(x, mask, cond, int(seed),
                                  float(dropout_rate),
                                  *[weights[key] for key in WEIGHT_KEYS])
    return z, ld + weights['ld_const'].sum() * mask.sum(dim=(1, 2))


# kernel launches of the forward pass (one per flow step); of the forward
# kernel's saving instantiation, the backward pass's recompute (one per flow
# step); and of the backward library's kernels, as its entry counts them: a
# fixed sequence of 34 per flow step (38 with conditioning)
flow_stack_train.forward_launches = 0
flow_stack_train.recompute_launches = 0
flow_stack_train.backward_launches = 0


@functools.cache
def load_train_forward_library() -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library, typed."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    lib = load_library('flow_train_fwd.cu')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_flow_train_fwd_f32.argtypes = (
        [vp] * (3 + len(WEIGHT_KEYS) + 2)
        + [ci, ci, ci, ci, ci, ctypes.c_uint, ctypes.c_float, ci, vp])
    lib.glow_flow_train_fwd_f32.restype = ci
    lib.glow_flow_train_time_tile.argtypes = []
    lib.glow_flow_train_time_tile.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_train_backward_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernels' library, typed."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    lib = load_library('flow_train_bwd.cu')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_flow_train_bwd_step_f32.argtypes = (
        [vp, vp] + [ci] * 8 + [ctypes.c_uint, ctypes.c_float, ci, vp,
                               ctypes.POINTER(ci)])
    lib.glow_flow_train_bwd_step_f32.restype = ci
    lib.glow_flow_train_bwd_split_rows.argtypes = []
    lib.glow_flow_train_bwd_split_rows.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib
