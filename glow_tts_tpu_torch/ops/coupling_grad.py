"""The train-direction flow stack: all flow steps forward with dropout
inside the coupling WaveNets, and a hand-written backward pass.

Replaces ``glow_tts_tpu/ops/coupling_grad.py`` (``_make_train_fwd_kernel``
and ``_make_train_bwd_kernel`` behind ``fused_flow_stack_train``).  The
kernels are ``csrc/flow_train_fwd.cu`` and ``csrc/flow_train_bwd.cu``; this
module holds their plain PyTorch version
(:func:`flow_stack_train_reference`, differentiable by autograd, the value
and gradient oracle) and the entry :func:`flow_stack_train`, which picks
between them by the tensor's device alone.

What bounds the pair on an H100: arithmetic.  A step costs 3.6 MFLOP per
valid squeezed frame forward, and the activation gradients and the weight
gradients are each that work again, against a few hundred bytes per frame.
The forward keeps a step's activations in shared memory (the flow-step
kernel's tiling and body: tensor-core GEMMs on weights split when packed,
live tiles only).  What the design of the backward does about it:

* no recompute where the activations fit.  The TPU kernel recomputes a step
  from its checkpoint because its fast memory is small; this card has 80 GB,
  so a forward that will be differentiated also writes what the backward
  reads (190 MB a step at 32 x 512 frames) when that is at most
  :data:`STORE_BUDGET_BYTES` for the whole stack (:func:`stores_activations`,
  a function of the shapes alone), and otherwise the backward recomputes
  step by step into one step's buffers as the TPU kernel does.  Both routes
  run the same device code for the saved values: the gradients are the same
  bits;
* both GEMMs on the tensor cores, as the error-compensated 3xTF32 product
  (:data:`TF32_PASSES`; :func:`matmul_3xtf32_reference` is its plain
  arithmetic), which keeps f32 accuracy where one TF32 pass keeps 3 digits;
* valid frames only: every gradient operand is zero past a sample's last
  valid frame, so tiles, warps and weight-gradient chunks past it are
  skipped; no value changes;
* 22 launches per flow step (the library counts them): an activation-
  gradient and a weight-gradient product that do not depend on each other
  share a launch, so that the second fills the SMs the ragged batch's
  skipped tiles leave idle; the last launch adds every partial of the
  weight-gradient chunks (whole samples, a split that is a function of the
  shapes) and of the per-sample column sums in a fixed order straight into
  the gradient tensors: no atomics, so two runs give the same bits.

GR mode's pitch operand (``pitch [B, T, ps]`` with ``w_pitch [S, n, ps,
2ch]``, ``ps`` = num_squeeze, added to every WaveNet layer's pre-gate sum
after the dropout) is a build of both sources of their own (``GLOW_PITCH``, as the deterministic
kernels' pitch builds): the wrappers load it only when a pitch operand
arrives, and count its launches apart.  Its backward adds one launch per
layer: ``dw_pitch`` as per-sample partials reduced in order with the other
weight gradients, and ``dpitch`` (skipped when the pitch operand wants no
gradient) added layer by layer in launch order.  MiniSpeech's 80 flow
channels (``Num_Squeeze: 1``) are a build of both sources of their own
too (``GLOW_CHANNELS=80``), loaded by the channel count and counted apart
(``*_c80_launches``); its pitch builds take the pitch operand 1 wide
(``*_c80_pitch_launches``).  Every other decoder shape the train builds
take (``ops/coupling.py::train_error``: 100-bin mels' C = 200, or 100 at
Num_Squeeze 1, 128-bin mels' 256, another WaveNet) is a build of both
sources of its own, made at its first use from
the shape's macros (``coupling.build_defines``) and counted under its
``coupling.build_tag`` (``*_c200_launches``, ...).  The forward computes the
WaveNet at ch padded to a multiple of 64 on zero-padded weights, ``b_in``,
conditioning rows and pitch weights (``coupling.padded_wavenet``), with the
dropout bits of the true columns, and stores what the backward reads at the
true ch; the backward computes at the true ch, so every gradient is at the
true width.

At bfloat16 (``x`` a bfloat16 tensor: ``config.compute_dtype``) the pair
computes what the TPU kernels compute at ``dt = bfloat16``
(``glow_tts_tpu/ops/coupling_grad.py``): the steps' inputs and outputs in
bfloat16, the activations rounded to it where the TPU kernel casts them
(the ActNorm output and ``x_a`` before their products, the residual stream
``h``, the gate, the masked skip sum) and so are the weights, the
conditioning rows and the pitch operand its wrapper casts; the sums
(``acc``, the skip sum), ``x_b``, the logdet and every gradient stay
float32.  Its kernels are builds of both sources with ``GLOW_BF16``: the
forward's products on bfloat16 tensor-core operands (``h`` and the gate
kept in bfloat16 in shared memory, their fragments read by ``ldmatrix``),
its saved values stored in bfloat16 (the TPU kernel keeps its checkpoint
in ``dt``), and the backward's GEMMs on bfloat16 tiles staged as they lie
(the activation gradients on ``wgmma``, the weight gradients on
``mma.sync.m16n8k16`` fed by ``ldmatrix.trans``), read from those stores,
from the weights rounded to bfloat16 (:func:`backward_weights_bf16`) and
from bfloat16 copies of the cotangents (:func:`cotangent_copies_bf16`)
that the epilogue making each one writes beside its float32 value: the
rounding the TPU kernel's ``.astype(dt)`` gives before each ``dot``.  The TPU
kernel also writes its per-batch-block weight-gradient partials of
``w_in`` and ``w_rs`` in bfloat16 (``gdt``), only because its VMEM is
scarce and their partition is its batch tile: that rounding has no
counterpart here, where every weight gradient sums in float32.  The plain
version at bfloat16 rounds the same activations (autograd rounds their
cotangents on the way back) and the weights by a straight-through rounding
whose gradient is float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from glow_tts_tpu_torch.ops import dropmask
from glow_tts_tpu_torch.ops.coupling import (SHIPPED_CHANNELS, SHIPPED_SHAPES,
                                             TC_KEYS, FlowShape, as_shape,
                                             body_width,
                                             check_train_shape,
                                             count_launches, kernel_cond,
                                             load_flow_library, pad_gate,
                                             padded_key, pitch_size,
                                             tf32_round,
                                             tile_report_pointer,
                                             valid_lengths, wavenet_stats,
                                             with_tensor_core_weights,
                                             zero_launch_counts)
from glow_tts_tpu_torch.ops.precision import rounded, rounded_weight

Weights = Dict[str, torch.Tensor]

# stacked [S, ...] weights in the order the forward library takes them;
# ``ld_const [S]`` rides beside them and never enters a kernel
WEIGHT_KEYS = ('an_logs', 'an_bias', 'mix_t', 'w_start', 'b_start', 'w_in',
               'b_in', 'w_rs', 'b_rs', 'w_end', 'b_end')


def weight_keys(pitch: bool) -> Tuple[str, ...]:
    """The stacked weights the autograd function takes, in order: those of
    :data:`WEIGHT_KEYS` and, with a pitch operand, ``w_pitch``."""
    return WEIGHT_KEYS + (('w_pitch',) if pitch else ())


def weight_shapes(s: int, c: int, ch: int, n: int, k: int, ps: int = 0
                  ) -> Dict[str, Tuple[int, ...]]:
    """The shapes of :func:`weight_keys`, ``w_pitch`` with a pitch operand
    of width ``ps``."""
    shapes = {'an_logs': (s, c), 'an_bias': (s, c), 'mix_t': (s, c, c),
              'w_start': (s, c // 2, ch), 'b_start': (s, ch),
              'w_in': (s, n, k, ch, 2 * ch), 'b_in': (s, n, 2 * ch),
              'w_rs': (s, n, ch, 2 * ch), 'b_rs': (s, n, 2 * ch),
              'w_end': (s, ch, c), 'b_end': (s, c)}
    if ps:
        shapes['w_pitch'] = (s, n, ps, 2 * ch)
    return shapes


def flow_stack_train_reference(x: torch.Tensor, mask: torch.Tensor,
                               weights: Weights,
                               cond: Optional[torch.Tensor] = None,
                               pitch: Optional[torch.Tensor] = None, *,
                               seed: int, dropout_rate: float = 0.0,
                               world=None
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
    ``cond`` and pitch are added.  Returns ``(z [B, T, C], logdet [B])``,
    ``z`` in ``x``'s dtype: at bfloat16 the module docstring's policy, each
    step's output rounded to it as the next step's input.  Under ``world``
    the WaveNets run sharded over its model group
    (``ops.coupling.wavenet_stats``), with the same masks."""
    dtype = x.dtype
    b, t, c = x.shape
    c2 = c // 2
    s_steps, n, k, _, ch2 = weights['w_in'].shape
    mask = mask.float()
    xc = x.float()
    ld = torch.zeros(b, device=x.device)

    def r(v):
        return rounded(v, dtype)

    def rw(name, *index):
        return rounded_weight(weights[name][index], dtype)

    for sj in range(s_steps):
        y = (weights['an_bias'][sj] + torch.exp(weights['an_logs'][sj]) * xc
             ) * mask
        yd = (r(y) @ rw('mix_t', sj)) * mask
        xa, xb = r(yd[..., :c2]), yd[..., c2:]
        drop = None
        if dropout_rate > 0.0:
            def drop(i, sj=sj):
                return dropmask.stack_mask(seed, sj, i, n, b, t, k, ch2,
                                           dropout_rate, x.device)
        mean, logs = wavenet_stats(
            xa, mask, {key: value[sj] for key, value in weights.items()},
            None if cond is None else cond[sj], pitch, dtype,
            b_in=weights['b_in'][sj], drop=drop, world=world)
        zb = (mean + torch.exp(logs) * xb) * mask
        ld = ld + (logs * mask).sum(dim=(1, 2))
        xc = r(torch.cat([xa, zb], dim=-1))
    ld = ld + weights['ld_const'].float().sum() * mask.sum(dim=(1, 2))
    return xc.to(dtype), ld


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


# what the backward pass reads of a flow step beside its input, over the
# M = B·T frames: written by the forward pass (stored) or recomputed
SAVED_KEYS = ('y', 'yd', 'xin', 'ts', 'skip', 'logs')
# the most a forward pass stores for its backward pass; above it the backward
# recomputes step by step (2.3 GB at 12 steps of 32 x 512 frames)
STORE_BUDGET_BYTES = 8 * 2 ** 30
# passes of the backward GEMMs' TF32 product: 3 is the error-compensated
# 3xTF32 (f32 accuracy), 1 a single TF32 pass (3 digits, kept for measuring)
TF32_PASSES = 3
# the bf16 build's: one bfloat16 product, accumulated in the tensor cores
# alone (the f32 build's second accumulator measured no closer to the f32
# plain version at bf16, and slower: PERF.md)
BF16_PASSES = 1
# kernels the backward library launches per flow step of n WaveNet layers,
# and per layer more in its pitch build
BACKWARD_LAUNCHES_PER_LAYER, BACKWARD_LAUNCHES_FIXED = 4, 6
BACKWARD_PITCH_LAUNCHES_PER_LAYER = 1


def backward_launches_per_step(n: int, pitch: bool = False) -> int:
    """Kernels of ``csrc/flow_train_bwd.cu`` behind one flow step's backward,
    with or without conditioning: per layer the res/skip conv's activation
    gradient, one launch of column sums, its weight gradient, and the k-tap
    conv's two gradients as one launch (with a pitch operand, one more: the
    pitch term's gradients); the affine's elementwise backward, three more
    such pairs (end conv, start conv, mixing), one launch of column sums and
    the reduction of all partials."""
    per_layer = BACKWARD_LAUNCHES_PER_LAYER + (
        BACKWARD_PITCH_LAUNCHES_PER_LAYER if pitch else 0)
    return BACKWARD_LAUNCHES_FIXED + per_layer * n


def _saved_shapes(m: int, c: int, ch: int, n: int
                  ) -> Dict[str, Tuple[int, ...]]:
    """ActNorm output ``y`` and mixing output ``yd`` ``[M, C]``, every
    layer's input ``xin [n, M, ch]`` and gate halves ``ts [n, M, 2ch]``
    (tanh, sigmoid), the masked skip sum ``[M, ch]``, ``logs [M, C/2]``."""
    return {'y': (m, c), 'yd': (m, c), 'xin': (n, m, ch),
            'ts': (n, m, 2 * ch), 'skip': (m, ch), 'logs': (m, c // 2)}


def saved_bytes_per_step(m: int, c: int, ch: int, n: int,
                         dtype: torch.dtype = torch.float32) -> int:
    """Bytes of what the backward pass reads of one flow step beside its
    input, at ``m`` frames, stored in ``dtype`` (the compute dtype: a
    bfloat16 forward stores bfloat16, as the TPU kernel keeps its
    checkpoint in ``dt``)."""
    shapes = _saved_shapes(m, c, ch, n)
    size = torch.empty((), dtype=dtype).element_size()
    return size * sum(math.prod(shapes[key]) for key in SAVED_KEYS)


def stores_activations(s_steps: int, m: int, c: int, ch: int, n: int,
                       dtype: torch.dtype = torch.float32) -> bool:
    """Whether a forward pass that will be differentiated stores every
    step's saved values (else the backward pass recomputes them): when they
    fit in :data:`STORE_BUDGET_BYTES`.  A function of the shapes and the
    compute dtype alone."""
    return (s_steps * saved_bytes_per_step(m, c, ch, n, dtype)
            <= STORE_BUDGET_BYTES)


def _saved_buffers(m: int, c: int, ch: int, n: int, device,
                   steps: Optional[int] = None,
                   dtype: torch.dtype = torch.float32
                   ) -> Dict[str, torch.Tensor]:
    """Uninitialised buffers of :func:`_saved_shapes` in ``dtype``, for
    one flow step or with a leading axis of ``steps``."""
    lead = () if steps is None else (steps,)
    return {key: torch.empty(lead + shape, device=device, dtype=dtype)
            for key, shape in _saved_shapes(m, c, ch, n).items()}


def matmul_3xtf32_reference(a: torch.Tensor, b: torch.Tensor,
                            passes: int = 3) -> torch.Tensor:
    """The arithmetic of the backward kernels' GEMMs in plain PyTorch:
    operands in TF32, products exact, sums in f32.  With 3 passes each
    operand is split into ``hi + lo`` (``hi`` rounded to TF32, ``lo`` the
    remainder cut to TF32, as the tensor cores read it) and the product is
    ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi`` (3xTF32); with 1 pass it is
    ``a_hi·b_hi``."""
    def cut(x):
        return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)

    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = cut(a - a_hi), cut(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _valid_lengths(mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[B]``: one past the last frame of each sample whose mask is
    not zero (the sample's length, for a prefix mask), on the mask's
    device."""
    return valid_lengths(mask).to(torch.int32)


# the weights the backward library's activation-gradient products read (its
# in[11..15]), f32 or, in the bf16 build, bfloat16
PRODUCT_WEIGHT_KEYS = ('mix_t', 'w_start', 'w_in', 'w_rs', 'w_end')


def backward_weights_bf16(weights: Weights) -> Weights:
    """The stacked weights of :data:`PRODUCT_WEIGHT_KEYS` rounded to
    bfloat16 (to nearest even: ``tensor.to(torch.bfloat16)``, the TPU
    kernel's cast of each dot's weight to ``dt``), in their own layout: the
    bf16 backward stages their rows (depth contiguous) into shared memory as
    they lie, so the rounding is all it needs.  Made once a backward pass,
    outside autograd."""
    return {key: weights[key].detach().to(torch.bfloat16).contiguous()
            for key in PRODUCT_WEIGHT_KEYS}


def cotangent_copies_bf16(m: int, c: int, ch2: int, device
                          ) -> Tuple[torch.Tensor, ...]:
    """Scratch of the bf16 backward (its out[33..35]): ``douts [m, c]``,
    ``drs [m, ch2]`` and ``dpre [m, ch2]`` in bfloat16, which the epilogues
    that make each float32 cotangent fill with its rounding, the operand of
    the products that read it."""
    return tuple(torch.empty((m, width), device=device, dtype=torch.bfloat16)
                 for width in (c, ch2, ch2))


def _kernel_weights(weights, dtype: torch.dtype = torch.float32) -> list:
    """The stacked weights in ``WEIGHT_KEYS`` order as the forward library
    of ``dtype`` takes them: ``w_in`` and ``w_rs`` in the tensor-core layout
    (:func:`~glow_tts_tpu_torch.ops.coupling.tensor_core_weights`), split
    now, outside autograd, from the f32 weights the backward reads (and for
    bfloat16 the mixing, start and end weights rounded to it), and the
    WaveNet at the body's width ``ch_pad`` (ch padded to a multiple of 64:
    the padded copies of ``coupling.padded_weights`` and ``b_in`` padded
    half by half) where that is not ch."""
    named = with_tensor_core_weights(dict(zip(WEIGHT_KEYS, weights)), dtype)
    ch_pad = body_width(named['w_rs'].shape[-2])
    if ch_pad != named['w_rs'].shape[-2]:
        with torch.no_grad():
            named['b_in'] = pad_gate(named['b_in'].float(),
                                     ch_pad).contiguous()
        named.update({key: named[padded_key(key)]
                      for key in ('w_start', 'b_start', 'b_rs', 'w_end')})
    return [named[TC_KEYS.get(key, key)] for key in WEIGHT_KEYS]


def _kernel_operands(cond, w_pitch, ch: int):
    """The conditioning rows ``[S, n, B, 2ch]`` and ``w_pitch [S, n, ps,
    2ch]`` (either None) as the forward library reads them: each gate half
    padded with zeros to the body's width where that is not ch (copies,
    outside autograd)."""
    ch_pad = body_width(ch)
    with torch.no_grad():
        return (None if cond is None else kernel_cond(cond, ch_pad),
                None if w_pitch is None
                else kernel_cond(w_pitch.detach(), ch_pad))


def _step_shape(c: int, weights) -> FlowShape:
    """The :class:`FlowShape` of a stack whose stacked weights ``weights``
    are in :data:`WEIGHT_KEYS` order (``w_in [S, n, k, ch, 2ch]``)."""
    _, n, k, ch, _ = weights[WEIGHT_KEYS.index('w_in')].shape
    return FlowShape(c, ch, n, k)


def _recompute(x_step, mask, cond, weights, saved, step: int, drop,
               pitch=None, w_pitch=None) -> None:
    """One launch of the forward kernel's saving instantiation: flow step
    ``step`` from its input ``x_step [B, T, C]`` (in the compute dtype) into
    ``saved`` (:func:`_saved_buffers`, at the true ch); ``weights`` as
    :func:`_kernel_weights` gives them, ``cond`` and ``w_pitch [S, n, ps,
    2ch]`` (with a ``pitch`` operand) as :func:`_kernel_operands` does."""
    b, t, c = x_step.shape
    n, _, ch = saved['xin'].shape
    # w_in_tc [S, n, k·ch_pad/d, ...] over w_rs_tc [S, n, ch_pad/d, ...]
    w_in, w_rs = (weights[WEIGHT_KEYS.index(key)] for key in ('w_in', 'w_rs'))
    shape = FlowShape(c, ch, n, w_in.shape[2] // w_rs.shape[2])
    bf16 = x_step.dtype == torch.bfloat16
    ps = 0 if pitch is None else pitch.shape[-1]
    lib = load_train_forward_library(ps, shape, bf16)
    err = lib.glow_flow_train_fwd_f32(
        x_step.data_ptr(), mask.data_ptr(),
        *[None if tensor is None else tensor.data_ptr()
          for tensor in (cond, pitch, w_pitch)],
        *[w.data_ptr() for w in weights], None,
        _pointers([saved[key] for key in SAVED_KEYS]), None, b, t, step,
        step + 1, *drop, TF32_PASSES,
        torch.cuda.current_stream(x_step.device).cuda_stream)
    _raise_on(err, lib, 'flow_stack_train recompute')
    count_launches(flow_stack_train, 'recompute', shape, ps, bf16=bf16)


class _FlowStackTrain(torch.autograd.Function):
    """The two kernels as one differentiable function of
    ``(x, cond, pitch, *weights)`` (``weights`` in :func:`weight_keys`
    order; the pitch builds where ``pitch`` is not None); returns
    ``(z, WaveNet logdet)``.  ``route``
    says what the forward pass leaves for a backward pass: ``'forward'``
    nothing but the steps' inputs (no gradient is wanted), ``'store'`` every
    step's saved values, ``'recompute'`` the steps' inputs, from which the
    backward pass recomputes them; ``passes`` is the number of TF32 passes of
    the backward GEMMs, ``forward_passes`` that of the forward's (1 only for
    measuring the route ``'forward'``); ``tiles`` a ``coupling.tile_report``
    the forward's launches fill, or None."""

    @staticmethod
    def forward(ctx, x, mask, cond, pitch, seed, rate, route, passes,
                forward_passes, tiles, *weights):
        b, t, c = x.shape
        s_steps, n, _, ch, _ = weights[WEIGHT_KEYS.index('w_in')].shape
        shape = _step_shape(c, weights)
        dtype = x.dtype
        bf16 = dtype == torch.bfloat16
        if bf16:
            # the operands the TPU kernel's wrapper casts to dt
            cond = None if cond is None else rounded(cond, dtype).contiguous()
            pitch = (None if pitch is None
                     else rounded(pitch, dtype).contiguous())
        ps = 0 if pitch is None else pitch.shape[-1]
        w_pitch = None if pitch is None else weights[len(WEIGHT_KEYS)]
        if bf16 and w_pitch is not None:
            w_pitch = rounded(w_pitch.detach(), dtype).contiguous()
        lib = load_train_forward_library(ps, shape, bf16)
        kernel_weights = _kernel_weights(weights[:len(WEIGHT_KEYS)], dtype)
        # at the forward's padded WaveNet width; the backward reads cond and
        # w_pitch at the true one
        kernel_cond_rows, kernel_w_pitch = _kernel_operands(cond, w_pitch,
                                                            ch)
        acts = torch.empty((s_steps + 1, b, t, c), device=x.device,
                           dtype=dtype)
        acts[0].copy_(x)
        n_tiles = -(-t // lib.glow_flow_train_time_tile())
        # per-(step, sample, time tile) partial logdets, summed below: no
        # atomics, so the result does not depend on block order
        ld_part = torch.empty((s_steps, b, n_tiles), device=x.device)
        drop = _dropout_args(seed, rate)
        stored = (_saved_buffers(b * t, c, ch, n, x.device, s_steps, dtype)
                  if route == 'store' else {})
        err = lib.glow_flow_train_fwd_f32(
            acts.data_ptr(), mask.data_ptr(),
            *[None if tensor is None else tensor.data_ptr()
              for tensor in (kernel_cond_rows, pitch, kernel_w_pitch)],
            *[w.data_ptr() for w in kernel_weights], ld_part.data_ptr(),
            _pointers([stored[key] for key in SAVED_KEYS]) if stored else None,
            tile_report_pointer('flow_stack_train', tiles, x), b, t, 0,
            s_steps, *drop, forward_passes,
            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, lib, 'flow_stack_train forward')
        count_launches(flow_stack_train, 'forward', shape, ps, s_steps, bf16)
        ctx.save_for_backward(acts, mask, cond, pitch, *stored.values(),
                              *weights)
        ctx.drop, ctx.route, ctx.passes = drop, route, passes
        # the recompute launches read the split weights and the padded
        # operands again; at bf16 the pitch term's backward reads w_pitch
        # rounded, as the forward did
        ctx.kernel_weights = kernel_weights if route == 'recompute' else None
        ctx.kernel_operands = ((kernel_cond_rows, kernel_w_pitch)
                               if route == 'recompute' else None)
        ctx.w_pitch = w_pitch if bf16 else None
        return acts[s_steps], ld_part.sum(dim=(0, 2))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz, dld):
        if ctx.route == 'forward':
            raise RuntimeError('flow_stack_train: this forward pass was run '
                               'for its outputs alone')
        acts, mask, cond, pitch, *rest = ctx.saved_tensors
        n_stored = len(SAVED_KEYS) if ctx.route == 'store' else 0
        stored, weights = rest[:n_stored], rest[n_stored:]
        keys = weight_keys(pitch is not None)
        named = dict(zip(keys, weights))
        s_steps, b, t, c = acts.shape[0] - 1, *acts.shape[1:]
        _, n, k, ch, ch2 = named['w_in'].shape
        shape = FlowShape(c, ch, n, k)
        ps = 0 if pitch is None else pitch.shape[-1]
        m, c2 = b * t, c // 2
        device = acts.device
        dtype = acts.dtype
        bf16 = dtype == torch.bfloat16
        bwd = load_train_backward_library(ps, shape, bf16)
        stream = torch.cuda.current_stream(device).cuda_stream

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, device=device, dtype=dtype)

        def chunks(taps, kseg, width):
            return bwd.glow_flow_train_bwd_chunks(b, taps, kseg, width)

        dz = (torch.zeros_like(acts[0]) if dz is None
              else dz.float().contiguous())
        dld = empty(b).zero_() if dld is None else dld.float().contiguous()
        lengths = _valid_lengths(mask)
        saved = (None if stored
                 else _saved_buffers(m, c, ch, n, device, dtype=dtype))
        # dacc, the pre-gate gradient after the dropout, where cond and the
        # pitch term were added; dyd (read by products alone) and the gate
        # (the res/skip weight gradient's operand) in the compute dtype, as
        # the TPU kernel rounds them
        scratch = [empty(m, c), empty(m, ch2), empty(m, ch2),
                   None if cond is None and pitch is None else empty(m, ch2),
                   empty(m, c, dtype=dtype), empty(m, 2 * c),
                   empty(m, ch, dtype=dtype)]
        # the bf16 build's weights and cotangent copies (in[11..15] and
        # out[33..35]); out[30..32] are the pitch build's
        product_weights = (backward_weights_bf16(named) if bf16 else
                           {key: named[key] for key in PRODUCT_WEIGHT_KEYS})
        copies = ([None] * (3 if pitch is None else 0)
                  + list(cotangent_copies_bf16(m, c, ch2, device))
                  if bf16 else [])
        # partials of the weight gradients (one per chunk of samples) and of
        # the column sums (one per sample), reused by every step
        partials = [empty(chunks(1, ch, c), ch, c),
                    empty(n, chunks(1, ch, ch2), ch, ch2),
                    empty(n, chunks(k, ch, ch2), k * ch, ch2),
                    empty(chunks(1, c2, ch), c2, ch),
                    empty(chunks(1, c, c), c, c),
                    empty(b, c), empty(n, b, ch2), empty(n, b, ch2),
                    empty(b, ch), empty(b, 2 * c)]
        grads = {key: torch.empty_like(value) for key, value in named.items()}
        dcond = None if cond is None else torch.empty_like(cond)
        pitch_inputs, pitch_outputs, dpitch = [], [], None
        if pitch is not None:
            # dpitch is added to step after step; w_pitch's per-sample
            # partials are reused by every step
            dpitch = (torch.zeros_like(pitch) if ctx.needs_input_grad[3]
                      else None)
            pitch_part = empty(n, b, pitch.shape[-1], ch2)
        # the cotangent walks down the steps through two buffers of its own
        # (the incoming dz is not written to)
        dx_in, dx_bufs = dz, [torch.empty_like(dz), torch.empty_like(dz)]
        w_pitch = (ctx.w_pitch if ctx.w_pitch is not None
                   else named.get('w_pitch'))
        launched = ctypes.c_int(0)
        for s in range(s_steps - 1, -1, -1):
            if stored:
                step_saved = [tensor[s] for tensor in stored]
            else:
                _recompute(acts[s], mask, ctx.kernel_operands[0],
                           ctx.kernel_weights, saved, s, ctx.drop, pitch,
                           ctx.kernel_operands[1])
                step_saved = list(saved.values())
            if pitch is not None:
                pitch_inputs = [pitch, w_pitch[s]]
                pitch_outputs = [grads['w_pitch'][s], dpitch, pitch_part]
            inputs = [acts[s], *step_saved, mask, dld, dx_in,
                      named['an_logs'][s],
                      *[product_weights[key][s]
                        for key in PRODUCT_WEIGHT_KEYS],
                      lengths, *pitch_inputs]
            outputs = [dx_bufs[s % 2], *scratch, *partials,
                       None if dcond is None else dcond[s],
                       *[grads[key][s] for key in WEIGHT_KEYS],
                       *pitch_outputs, *copies]
            err = bwd.glow_flow_train_bwd_step_f32(
                _pointers(inputs), _pointers(outputs), b, t, c, ch, n, k, s,
                *ctx.drop, ctx.passes, stream, ctypes.byref(launched))
            count_launches(flow_stack_train, 'backward', shape, ps,
                           launched.value, bf16)
            _raise_on(err, bwd, 'flow_stack_train backward')
            dx_in = dx_bufs[s % 2]
        return (dx_in, None, dcond, dpitch, None, None, None, None, None,
                None, *[grads[key] for key in keys])


def _check_cuda_inputs(x, mask, weights, cond, pitch) -> None:
    """Raise on what the kernels are not built for."""
    if x.device.type != 'cuda':
        raise ValueError(f'flow_stack_train: no kernel for device {x.device}')
    if pitch is not None and 'w_pitch' not in weights:
        raise ValueError('flow_stack_train: a pitch operand needs w_pitch '
                         'among the weights')
    b, t, c = x.shape
    s_steps, n, k, ch, ch2 = weights['w_in'].shape
    ps = 0 if pitch is None else pitch.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'flow_stack_train: x must be float32 or bfloat16, '
                         f'got {x.dtype} (ROADMAP.md A.5)')
    check_train_shape('flow_stack_train', c, (n, k, ch, ch2), ps,
                      x.dtype == torch.bfloat16)
    tensors = {'mask': (mask, (b, t, 1)),
               'ld_const': (weights['ld_const'], (s_steps,)),
               **{key: (weights[key], shape) for key, shape
                  in weight_shapes(s_steps, c, ch, n, k, ps).items()}}
    if cond is not None:
        tensors['cond'] = (cond, (s_steps, n, b, ch2))
    if pitch is not None:
        tensors['pitch'] = (pitch, (b, t, ps))
    for name, (tensor, shape) in tensors.items():
        if (tensor.device != x.device or tensor.dtype != torch.float32
                or tuple(tensor.shape) != shape
                or not tensor.is_contiguous()):
            raise ValueError(
                f'flow_stack_train: {name} must be a contiguous float32 '
                f'tensor of shape {shape} on {x.device}; got '
                f'{tuple(tensor.shape)} {tensor.dtype} on {tensor.device}')
    if tuple(x.shape) != (b, t, c) or not x.is_contiguous():
        raise ValueError(f'flow_stack_train: x must be contiguous; got '
                         f'strides {x.stride()}')


def _apply_kernels(x, mask, weights, cond, seed, dropout_rate,
                   route: Optional[str] = None,
                   passes: Optional[int] = None,
                   forward_passes: int = TF32_PASSES,
                   tiles: Optional[torch.Tensor] = None,
                   pitch: Optional[torch.Tensor] = None):
    """``_FlowStackTrain`` on checked CUDA operands (the pitch builds with
    a ``pitch`` operand).  ``route`` is chosen
    here: ``'forward'`` when no gradient can be asked for, else by
    :func:`stores_activations`; tests and measurements force ``'store'`` or
    ``'recompute'`` (and the number of TF32 passes of the backward's and,
    on the route ``'forward'``, the forward's products) through this
    function, and may have the forward's launches report their tiles into
    ``tiles`` (``coupling.tile_report``).  ``passes`` defaults to
    :data:`TF32_PASSES`, at bfloat16 to :data:`BF16_PASSES`; one TF32 pass
    (forward or backward) is built at the shipped shapes alone."""
    if passes is None:
        passes = BF16_PASSES if x.dtype == torch.bfloat16 else TF32_PASSES
    stack = [weights[key] for key in weight_keys(pitch is not None)]
    if route is None:
        wanted = torch.is_grad_enabled() and any(
            tensor is not None and tensor.requires_grad
            for tensor in (x, cond, pitch, *stack))
        b, t, c = x.shape
        s_steps, n, _, ch, _ = weights['w_in'].shape
        route = ('forward' if not wanted else
                 'store' if stores_activations(s_steps, b * t, c, ch, n,
                                               x.dtype)
                 else 'recompute')
    shipped = _step_shape(x.shape[-1], stack) in SHIPPED_SHAPES
    if forward_passes != TF32_PASSES and (route != 'forward' or not shipped):
        raise ValueError('flow_stack_train: one TF32 pass in the forward '
                         'is for measuring, on the route \'forward\' only, '
                         'at the shipped shapes')
    if passes == 1 and x.dtype == torch.float32 and not shipped:
        raise ValueError('flow_stack_train: one TF32 pass in the backward '
                         'is for measuring, at the shipped shapes')
    z, ld = _FlowStackTrain.apply(x, mask, cond, pitch, int(seed),
                                  float(dropout_rate), route, passes,
                                  forward_passes, tiles, *stack)
    return z, ld + weights['ld_const'].sum() * mask.sum(dim=(1, 2))


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
    return _apply_kernels(x, mask, weights, cond, seed, dropout_rate,
                          pitch=pitch)


# kernel launches of the forward pass (one per flow step); of the forward
# kernel's saving instantiation as the backward pass's recompute (one per
# flow step, none where the forward pass stored); and of the backward
# library's kernels, as its entry counts them: a fixed sequence of
# backward_launches_per_step(n) per flow step.  The pitch builds' and the
# other shapes' builds' launches count apart, under the same names with
# ``_pitch``, ``_c80``, ``_c80_pitch``, ``_c200``, ... (``coupling.build_tag``),
# and the bfloat16 builds' with ``_bf16`` before those
# (``coupling.count_launches``).
for _what in ('forward', 'recompute', 'backward'):
    zero_launch_counts(flow_stack_train, _what)
del _what


def _check_product_operands(**tensors: torch.Tensor) -> None:
    for name, tensor in tensors.items():
        if (tensor.device.type != 'cuda' or tensor.dtype != torch.float32
                or not tensor.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous float32 CUDA '
                             f'tensor; got {tensor.dtype} on {tensor.device}')


def _dgrad_product(a: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                   passes: int = TF32_PASSES,
                   channels: int = SHIPPED_CHANNELS) -> torch.Tensor:
    """One launch of the backward library's activation-gradient GEMM alone,
    for tests and timing: ``a [B, T, K]``, ``w [taps, N, K]``, ``mask [B, T,
    1]`` → ``[B, T, N]``, the k-tap transposed conv of ``a`` under the
    mask, in the library built for ``channels`` (whose depth K is a
    multiple of 32, or, in a build whose channels are not, of 4)."""
    _check_product_operands(a=a, w=w, mask=mask)
    b, t, kseg = a.shape
    taps, width, depth = w.shape
    if (depth != kseg or kseg % (4 if channels % 32 else 32) or width % 8
            or mask.shape != (b, t, 1)):
        raise ValueError(f'dgrad product of a {tuple(a.shape)}, w '
                         f'{tuple(w.shape)}, mask {tuple(mask.shape)}')
    lib = load_train_backward_library(channels=channels)
    out = torch.empty((b, t, width), device=a.device)
    lengths = _valid_lengths(mask)
    err = lib.glow_flow_train_bwd_dgrad_f32(
        a.data_ptr(), w.data_ptr(), mask.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, t, kseg, kseg, kseg, taps, width, passes,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, lib, 'flow_stack_train dgrad')
    return out


def _wgrad_product(p: torch.Tensor, g: torch.Tensor, mask: torch.Tensor,
                   taps: int = 1, passes: int = TF32_PASSES) -> torch.Tensor:
    """The backward library's weight-gradient GEMM and its reduction alone
    (two launches), for tests and timing: ``p [B, T, K]``, ``g [B, T, N]``,
    ``mask [B, T, 1]`` → ``[taps · K, N]``, the sum over the frames below
    each sample's length of ``p[frame + tap − pad]ᵀ · g[frame]``."""
    _check_product_operands(p=p, g=g, mask=mask)
    b, t, kseg = p.shape
    width = g.shape[2]
    if (g.shape[:2] != (b, t) or kseg % 4 or width % 4
            or mask.shape != (b, t, 1)):
        raise ValueError(f'wgrad product of p {tuple(p.shape)}, g '
                         f'{tuple(g.shape)}, mask {tuple(mask.shape)}')
    lib = load_train_backward_library()
    part = torch.empty((lib.glow_flow_train_bwd_chunks(b, taps, kseg, width),
                        taps * kseg, width), device=p.device)
    out = torch.empty((taps * kseg, width), device=p.device)
    lengths = _valid_lengths(mask)
    err = lib.glow_flow_train_bwd_wgrad_f32(
        p.data_ptr(), g.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, t, kseg, width, kseg, taps, width, passes,
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(err, lib, 'flow_stack_train wgrad')
    return out


def load_train_forward_library(pitch=False, channels=SHIPPED_CHANNELS,
                               bf16: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library for
    ``channels`` (a ``coupling.FlowShape``, or a flow channel count at the
    shipped WaveNet), its pitch build with ``pitch`` (True, or the
    operand's width), its bfloat16 build with ``bf16``, typed; held to the
    geometry it reports (``coupling.geometry`` with ``train``)."""
    return _load_train_forward(pitch_size(as_shape(channels), pitch),
                               as_shape(channels), bool(bf16))


@functools.cache
def _load_train_forward(pitch: int, shape: FlowShape,
                        bf16: bool) -> ctypes.CDLL:
    lib = load_flow_library('flow_train_fwd.cu', pitch, shape, bf16)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_flow_train_fwd_f32.argtypes = (
        [vp] * (5 + len(WEIGHT_KEYS) + 3)
        + [ci, ci, ci, ci, ci, ctypes.c_uint, ctypes.c_float, ci, ci, vp])
    lib.glow_flow_train_fwd_f32.restype = ci
    lib.glow_flow_train_time_tile.argtypes = []
    lib.glow_flow_train_time_tile.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_train_backward_library(pitch=False, channels=SHIPPED_CHANNELS,
                                bf16: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the backward kernels' library for
    ``channels`` (a ``coupling.FlowShape``, or a flow channel count at the
    shipped WaveNet), its pitch build with ``pitch`` (True, or the
    operand's width), its bfloat16 build with ``bf16``, typed."""
    return _load_train_backward(pitch_size(as_shape(channels), pitch),
                                as_shape(channels), bool(bf16))


@functools.cache
def _load_train_backward(pitch: int, shape: FlowShape,
                         bf16: bool) -> ctypes.CDLL:
    lib = load_flow_library('flow_train_bwd.cu', pitch, shape, bf16)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.glow_flow_train_bwd_step_f32.argtypes = (
        [vp, vp] + [ci] * 8 + [ctypes.c_uint, ctypes.c_float, ci, ci, vp,
                               ctypes.POINTER(ci)])
    lib.glow_flow_train_bwd_step_f32.restype = ci
    lib.glow_flow_train_bwd_chunks.argtypes = [ci] * 4
    lib.glow_flow_train_bwd_chunks.restype = ci
    lib.glow_flow_train_bwd_max_reduce.argtypes = []
    lib.glow_flow_train_bwd_max_reduce.restype = ci
    lib.glow_flow_train_bwd_dgrad_f32.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    lib.glow_flow_train_bwd_dgrad_f32.restype = ci
    lib.glow_flow_train_bwd_wgrad_f32.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    lib.glow_flow_train_bwd_wgrad_f32.restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib
