"""The deterministic flow of the Glow decoder as CUDA kernels, one per
route of ``config.coupling_backend``:

* :func:`flow_step` (``csrc/flow_step.cu``) replaces
  ``glow_tts_tpu/ops/coupling.py::_make_kernel(flowstep=True)`` (entry
  ``fused_flow_step``): ActNorm → block-sparse invertible 1×1 → WaveNet
  affine coupling, in reverse order on the inverse pass.
* :func:`coupling` (``csrc/coupling.cu``) replaces
  ``_make_kernel(flowstep=False)`` (entry ``fused_coupling``): the affine
  coupling alone, on the two halves of the channels.
* :func:`flow_stack` (``csrc/flow_stack.cu``) replaces
  ``_make_mega_kernel`` (entry ``fused_flow_stack``): all the flow steps in
  one launch, over weights stacked along a leading step axis.

GR mode's pitch operand (``pitch [B, T, ps]`` with ``w_pitch [n, ps, 2ch]``
among the weights: ``pitch·w_pitch[i]`` added per frame to layer ``i``'s
pre-gate sum, ``ps = num_squeeze``: :func:`pitch_width`) goes to each
kernel's pitch instantiation, a library of its own built at the first call
that has a pitch operand.  The decoder's shape picks the library too
(:class:`FlowShape`: the flow's channels and the WaveNet's width, layers
and taps): the shipped config's 160 channels, MiniSpeech's 80, 100-bin
mels' 200 (100 at Num_Squeeze 1), 128-bin mels' 256, any shape of the
envelope (:func:`check_envelope`; others raise
naming ``ROADMAP.md`` B.2), each built at its first call with its shape's
macros (:func:`build_defines`) and held at load to the tile geometry
Python computes for it (:func:`geometry`); each build counts its launches
apart (:func:`count_launches`).  A body computes the WaveNet at a padded
width (:func:`padded_wavenet`: zero weights, biases, conditioning rows and
pitch weights, so the padded channels carry exact zeros), on weights
padded once where they are packed.  The train kernels
(``ops/coupling_grad.py``) build for the same shapes, less those whose
stored rows or layer count they cannot take (:func:`train_error`), each
library reporting its :func:`geometry` with ``train=True``.

Beside each wrapper stands its plain PyTorch version (``*_reference``);
the wrapper picks between kernel and plain version by the tensor's device
alone: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

What bounds them on an H100: arithmetic.  Per squeezed frame a step costs
about 3.6 MFLOP (4 layers × (k=5 conv 192→384 + 1×1 192→384), plus the
start, end and mixing 1×1s), so one B=32 decode of 1024 mel frames
(512 squeezed, 12 steps) is about 0.71 TFLOP, while its activations are
a few MB per step.  The unfused version writes every ``[B, T, 384]``
intermediate to device memory and back; the kernels keep a whole step's
activations in shared memory: one block per (sample, 32-frame tile) loads
the tile plus the WaveNet's receptive-field halo (8 frames each side at
k=5, 4 layers), recomputes the halo instead of exchanging it, and writes
only the step's output.  The k-tap convs and the res/skip 1×1s (~95 % of
the FLOPs) run on the tensor cores as the error-compensated 3xTF32 product
(f32 accuracy; :data:`TF32_PASSES`), on weights split into TF32 halves
once, where they are packed (:func:`tensor_core_weights`).  Each kernel
computes only the tiles that hold a valid frame: :func:`live_tile_schedule`
is the work list of ``flow_step`` and ``coupling``,
:func:`stack_tile_schedule` that of ``flow_stack``, whose steps follow each
other tile by tile, not launch by launch.

At bfloat16 (``x`` a bfloat16 tensor: ``config.compute_dtype`` or
``inference_dtype``) each of the three computes what its TPU kernel computes
at ``dt = bfloat16``: input and output in bfloat16; the activations rounded to
it where the TPU kernel casts them (the ActNorm output and ``x_a`` before
the mixing and the start conv, the residual stream ``h``, the gate, the
masked skip sum), and so are the weights and operands its wrapper casts
(``mix_t``, ``w_start``, ``w_in``, ``w_rs``, ``w_end``, ``w_pitch``, the
conditioning rows and the pitch operand); every product sums in float32,
and ``x_b``, the sums and the logdet stay float32; ``flow_stack`` carries
the stream between the steps in bfloat16, as the TPU kernel's carry is in
``dt``.  Their kernels are builds of each source with ``GLOW_BF16``
(:func:`build_defines`), whose big products run on the tensor cores with
bfloat16 operands (``mma.sync.m16n8k16``) on weights laid out once, where
they are packed (:func:`tensor_core_weights` with ``dtype``).  All three
run one body of their own for Hopper (``csrc/flow_ring.cuh``:
:data:`RING_TIME_TILE`-frame tiles, every product on ``wgmma`` over weight
slices staged through a ring in shared memory; ``coupling`` the flow step's
WaveNet and affine without ActNorm and the mixing, on ``x_a`` and ``x_b``
read where they lie), which takes its products' weights in
:func:`ring_layout_bf16` (:func:`ring_weights`, under :data:`RING_KEYS`'
names, packed once by ``FlowStep.weights``; :func:`with_kernel_weights`
for a hand-made dict).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from glow_tts_tpu_torch.ops.precision import rounded, rounded_weight
from glow_tts_tpu_torch.parallel.tp import (copy_to_model, reduce_from_model,
                                            scatter_to_model)

Weights = Dict[str, torch.Tensor]

# the flow channel count of the shipped config (Num_Squeeze 2), whose
# libraries are built without a GLOW_CHANNELS macro
SHIPPED_CHANNELS = 160


class FlowShape(NamedTuple):
    """The widths a flow kernel's library is compiled for: the flow's
    channels (``mel_dim · num_squeeze``) and the WaveNet's ``ch`` channels,
    ``n_layers`` layers and ``kernel_size`` taps."""
    channels: int
    ch: int = 192
    n_layers: int = 4
    kernel_size: int = 5

    @property
    def halo(self) -> int:
        """Frames of receptive field a side: ``n_layers·(kernel_size−1)/2``."""
        return self.n_layers * (self.kernel_size - 1) // 2


SHIPPED_SHAPE = FlowShape(SHIPPED_CHANNELS)
# the shipped shapes, the shipped config's and MiniSpeech's (Num_Squeeze 1,
# 80 channels): the builds that carry the measuring instantiations (one
# TF32 pass of #3 and #5, the ring body's timed one: GLOW_SHIPPED_SHAPE in
# csrc/flow_common.cuh)
BUILT_CHANNELS = (SHIPPED_CHANNELS, 80)
SHIPPED_SHAPES = tuple(FlowShape(c) for c in BUILT_CHANNELS)
# the pitch operand's width (num_squeeze) that the 160- and 80-channel
# builds take without a GLOW_PITCH_SIZE macro (csrc/flow_common.cuh)
SHIPPED_PITCH_SIZE = {SHIPPED_CHANNELS: 2, 80: 1}
# the shapes every flow kernel (#2, #3, #4, and the train pair #5, #6) is
# built for, each at its first use: C a multiple of 4 up to 256 (two halves
# of an even width: 100-bin mels at Num_Squeeze 1 are 100, at 2 200; 128-bin
# mels at 2 are 256), ch up to 192 (each body's WaveNet width,
# zero-padded), k odd and a halo of at most 16 frames a side (the ring
# body's 64-row tile keeps 32 owned frames).  Every such build fits a
# block: the ring body owns fewer frames a tile where its block needs the
# room (ring_time_tile), #5 stores without its saving stage where that
# does not fit (geometry with train)
ENVELOPE = {'channels': 256, 'grain': 4, 'ch': 192, 'halo': 16}
# the ring body's tile: 64 rows (one m64 block of wgmma) of which at most 48
# are owned, and at least 32
RING_ROWS, RING_MAX_TILE, RING_MIN_TILE = 64, 48, 32
# the shared memory of a block on an H100 (227 KB)
BLOCK_BYTES = 232448
# the live-tile list's ints in a block (csrc/flow_common.cuh::live_tiles)
# for the largest batch a launch takes
MAX_BATCH = 1024
# the macro a pitch instantiation's library is built with
PITCH_BUILD = ('GLOW_PITCH',)
# and a bfloat16 build's
BF16_BUILD = ('GLOW_BF16',)
# the build macros of a shape, beside its field, each omitted where it
# equals the shipped value (so the 160- and 80-channel libraries keep their
# names and their hashes' inputs)
SHAPE_MACROS = (('channels', 'GLOW_CHANNELS'), ('ch', 'GLOW_CH'),
                ('n_layers', 'GLOW_LAYERS'), ('kernel_size', 'GLOW_KSIZE'))
# what a deterministic flow library reports of its build
# (glow_flow_geometry: csrc/flow_common.cuh::write_geometry), in order
GEOMETRY_FIELDS = ('channels', 'ch', 'n_layers', 'kernel_size', 'pitch_size',
                   'time_tile', 'ch_pad', 'ring_depth', 'half_small',
                   'half_big', 'smem_bytes', 'stage_w_pitch')
# the sources whose libraries report it: the deterministic kernels', and
# the train forward's (TRAIN_GEOMETRY_SOURCES: geometry(..., train=True))
GEOMETRY_SOURCES = ('flow_step.cu', 'coupling.cu', 'flow_stack.cu',
                    'flow_train_fwd.cu')
TRAIN_GEOMETRY_SOURCES = ('flow_train_fwd.cu',)
# the most WaveNet layers a train build takes: flow_train_bwd.cu adds every
# gradient in one launch of 7 + 5 n jobs (a pitch build's), 32 bytes each,
# within the 4 KB of a launch's parameters (only k = 1 has a halo that
# lets n past 16)
TRAIN_MAX_LAYERS = ((4096 - 8) // 32 - 7) // 5


def as_shape(shape) -> FlowShape:
    """``shape`` as a :class:`FlowShape`: a flow channel count alone is the
    shipped WaveNet's (ch 192, 4 layers, k 5) at that width."""
    if isinstance(shape, FlowShape):
        return shape
    if isinstance(shape, int):
        return FlowShape(shape)
    return FlowShape(*shape)


def shape_of(channels: int, w_in_shape: Tuple[int, ...]) -> FlowShape:
    """The :class:`FlowShape` of ``channels`` flow channels and a WaveNet
    whose ``w_in`` is ``[n, k, ch, 2ch]``."""
    n, k, ch = w_in_shape[:3]
    return FlowShape(channels, ch, n, k)


def config_shape(config) -> FlowShape:
    """The decoder's :class:`FlowShape` of ``config``."""
    wavenet = config.decoder.affine_coupling.wavenet
    return FlowShape(config.sound.mel_dim * config.decoder.num_squeeze,
                     config.decoder.affine_coupling.calc_channels,
                     wavenet.num_layers, wavenet.kernel_size)


def pitch_width(squeeze) -> int:
    """The pitch operand's width: num_squeeze (``squeeze``, or a config's
    ``decoder.num_squeeze``), as the JAX package squeezes the pitch."""
    if not isinstance(squeeze, int):
        squeeze = squeeze.decoder.num_squeeze
    if squeeze < 1:
        raise ValueError(f'num_squeeze is at least 1, got {squeeze}')
    return squeeze


def default_pitch_size(channels: int) -> int:
    """The pitch width a build of ``channels`` channels is named by without
    a number (:func:`build_tag`) and takes for ``pitch=True``: the 160- or
    80-channel build's own (:data:`SHIPPED_PITCH_SIZE`), else 2 (the
    shipped YAML's Num_Squeeze)."""
    return SHIPPED_PITCH_SIZE.get(channels, 2)


def pitch_size(shape, pitch) -> int:
    """The pitch operand's width of a build: ``pitch`` False (or 0) for
    none, an int for that width, True for :func:`default_pitch_size`."""
    if pitch is True:
        return default_pitch_size(as_shape(shape).channels)
    return int(pitch or 0)


def envelope_error(shape) -> Optional[str]:
    """Why no build of the deterministic kernels takes ``shape``, or None
    where one does (:data:`ENVELOPE`)."""
    shape = as_shape(shape)
    c, ch, n, k = shape
    if c % ENVELOPE['grain'] or not 8 <= c <= ENVELOPE['channels']:
        return (f'channels {c}: a multiple of {ENVELOPE["grain"]} from 8 to '
                f'{ENVELOPE["channels"]}')
    if not 0 < ch <= ENVELOPE['ch']:
        return f'ch {ch}: up to {ENVELOPE["ch"]}'
    if n < 1 or k < 1 or k % 2 == 0:
        return f'n_layers {n}, kernel_size {k}: at least one layer, k odd'
    if shape.halo > ENVELOPE['halo']:
        return (f'halo n_layers·(k−1)/2 = {shape.halo}: at most '
                f'{ENVELOPE["halo"]} frames')
    return None


def budget_error(shape, bf16: bool, pitch: int = 0) -> Optional[str]:
    """Why the build of ``shape`` (bfloat16 with ``bf16``, a pitch operand
    ``pitch`` wide) does not fit a block's shared memory, or None."""
    need = geometry(shape, bf16, pitch)['block_bytes']
    if need > BLOCK_BYTES:
        return (f'the {"bfloat16" if bf16 else "float32"} build needs '
                f'{need} bytes of shared memory a block, over the '
                f'{BLOCK_BYTES} of an H100')
    return None


def check_envelope(name: str, shape, pitch_size: int = 0,
                   bf16: Optional[bool] = None) -> FlowShape:
    """``shape`` as a :class:`FlowShape`, or raise naming ``ROADMAP.md`` B.2
    if no build of the deterministic kernels takes it (or a pitch operand
    ``pitch_size`` wide, which must divide the channels: num_squeeze; or,
    for the build of ``bf16`` where it is given, over a block's shared
    memory: :func:`budget_error`)."""
    shape = as_shape(shape)
    why = envelope_error(shape)
    if why is None and pitch_size and shape.channels % pitch_size:
        why = (f'a pitch operand {pitch_size} wide (num_squeeze) does not '
               f'divide {shape.channels} channels')
    if why is None and bf16 is not None:
        why = budget_error(shape, bf16, pitch_size)
    if why is not None:
        raise ValueError(f'{name}: no flow kernel build takes {shape}: {why} '
                         '(other shapes: ROADMAP.md B.2)')
    return shape


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def body_width(ch: int) -> int:
    """The WaveNet width the float32 body (and #5's bfloat16 one) computes
    at: ch padded to a multiple of 64, the tensor-core tiles' grain
    (``csrc/flow_common.cuh::kChPad``)."""
    return _round_up(ch, 64)


def f32_smem_bytes(c: int, ch: int, n: int, k: int, tt: int) -> int:
    """``Shape<c, ch, n, k, tt>::smem_bytes`` of ``csrc/flow_common.cuh``:
    the float32 body's dynamic buffers of a block (``ch`` padded)."""
    pad = (k - 1) // 2
    halo = n * pad
    r = tt + 2 * halo
    hp = gp = ch + 4
    sp = ch + 8

    def mt(rows):
        return -(-rows // 16)

    def span(rows):
        return 8 * -(-rows // 8)

    def layer_rows(i):
        return r - 2 * pad * (i + 1)

    x_rows = max(span(r), halo + span(tt))
    h_rows = max([r] + [pad * (i + 1) - pad + 16 * mt(layer_rows(i)) + k - 1
                        for i in range(n)])
    g_floats = max([max(span(r), span(tt)) * c]
                   + [16 * mt(layer_rows(i)) * gp for i in range(n)])
    floats = (x_rows * c + h_rows * hp + g_floats + span(tt) * sp
              + _round_up(x_rows, 4))
    return 4 * floats


def ring_smem_bytes(c: int, n: int, k: int, tt: int) -> int:
    """``RingShape<c, 192, n, k, tt>::smem_bytes`` of ``csrc/flow_ring.cuh``:
    the ring body's dynamic buffers of a block owning ``tt`` frames a tile,
    the ring and 1 KB to align them included."""
    pad = (k - 1) // 2
    r, ch, depth = RING_ROWS, 192, 64
    big = 2 * depth * 2 * ch
    hp = gp = sp = ch + 8
    xp = _round_up(c, depth) + 8
    ap = _round_up(c // 2, depth) + 8
    h = 2 * (r + 2 * pad) * hp
    g = 2 * r * max(gp, xp)
    s = max(4 * tt * sp, 2 * r * ap, 4 * tt * c)
    return 2 * big + h + g + s + 4 * tt * (c // 2) + 4 * r + 1024


def _besides_buffers(static: int, pitch: int, rows: int) -> int:
    """A block's shared memory besides its dynamic buffers: the live-tile
    list of MAX_BATCH samples, the static arrays and the pitch operand's
    staged rows (w_pitch's stage is counted apart, where it fits)."""
    return 4 * (2 * MAX_BATCH + 1) + static + 4 * pitch * rows


def ring_time_tile(c: int, n: int, k: int, pitch: int = 0) -> int:
    """The frames a tile of the ring body owns at ``c`` channels, ``n``
    layers of ``k`` taps and a pitch operand ``pitch`` wide
    (``csrc/flow_ring.cuh::ring_time_tile``): 64 − 2·halo, at most 48, where
    the block fits an H100's shared memory with the live-tile list and the
    pitch rows; else the largest multiple of 8 below it that fits (40 at C
    = 216 … 256 without a pitch operand), at least 32."""
    tt = min(RING_MAX_TILE, RING_ROWS - n * (k - 1))
    while tt > RING_MIN_TILE and (
            ring_smem_bytes(c, n, k, tt)
            + _besides_buffers(8 * c + 128, pitch, RING_ROWS) > BLOCK_BYTES):
        tt = (tt - 1) // 8 * 8
    return tt


def geometry(shape, bf16: bool = False, pitch: int = 0,
             train: bool = False) -> Dict[str, int]:
    """The tile geometry of the build of ``shape`` (:class:`FlowShape` or a
    flow channel count) at bfloat16 (the ring body) or float32, with a
    pitch operand ``pitch`` wide (0: none): one function for every build,
    which :func:`build_defines` hands to ``nvcc`` as the shape's macros and
    which each library reports back (:data:`GEOMETRY_FIELDS`; the loader
    raises on a difference).  With ``train``, the train forward's
    (``csrc/flow_train_fwd.cu``, #5): the float32 body at both dtypes (its
    bfloat16 build keeps h and the gate in bfloat16 over the same buffers)
    with the saving stage of the owned rows' gate halves
    (``Shape::SAVE_FLOATS``, ``4·TT·(2·ch_pad + 4)`` bytes) in
    ``smem_bytes`` where the block has room for it (``save_stage``, 0
    where #5 stores the gate halves straight from its registers).

    * ``time_tile``: owned frames of a tile (the float32 body's 32; the
      ring body's :func:`ring_time_tile`, so a tile with its halo lies in
      one 64-row ``wgmma`` block);
    * ``ch_pad``: the WaveNet width the body computes at, ``ch`` padded with
      zero weights (float32: to a multiple of 64, the tensor-core tiles'
      grain; ring: 192, the two warpgroups' 96-column halves);
    * ``ring_depth``, ``half_small``, ``half_big`` (ring only, else 0): a
      weight slice's depth, and the columns a warpgroup takes of a 1x1
      conv (each output half padded to 96, or 192 where C/2 > 96) and of a
      WaveNet product;
    * ``smem_bytes``: the block's dynamic buffers (without the live-tile
      list); ``stage_w_pitch``: 1 where the step's ``w_pitch`` is staged in
      shared memory beside them (where it fits the block), 0 where the
      epilogue reads it from global memory."""
    c, ch, n, k = as_shape(shape)
    halo = n * (k - 1) // 2
    if bf16 and not train:
        tt = ring_time_tile(c, n, k, pitch)
        out = {'time_tile': tt, 'ch_pad': 192, 'ring_depth': 64,
               'half_small': 96 * -(-(c // 2) // 96), 'half_big': 192,
               'smem_bytes': ring_smem_bytes(c, n, k, tt), 'save_stage': 0}
        # the ActNorm tables; the warps' sums and the ring's barriers; the
        # pitch stage's rows are the 64 of a tile
        static, rows = 8 * c + 128, RING_ROWS
    else:
        tt, ch_pad = 32, body_width(ch)
        static, rows = 128, tt + 2 * halo
        buffers = f32_smem_bytes(c, ch_pad, n, k, tt)
        save = 4 * tt * (2 * ch_pad + 4) if train else 0
        staged = int(train and buffers + save + _besides_buffers(
            static, pitch, rows) <= BLOCK_BYTES)
        out = {'time_tile': tt, 'ch_pad': ch_pad, 'ring_depth': 0,
               'half_small': 0, 'half_big': 0,
               'smem_bytes': buffers + save * staged, 'save_stage': staged}
    # the block's shared memory besides the buffers (the live-tile list,
    # the static arrays, the pitch stage: the tile's pitch rows, and the
    # step's w_pitch where that fits)
    base = out['smem_bytes'] + _besides_buffers(static, pitch, rows)
    w_stage = 4 * pitch * n * 2 * out['ch_pad']
    out['stage_w_pitch'] = int(bool(pitch) and base + w_stage <= BLOCK_BYTES)
    out['block_bytes'] = base + w_stage * out['stage_w_pitch']
    return out


def build_defines(shape=SHIPPED_CHANNELS, pitch=False,
                  bf16: bool = False) -> Tuple[str, ...]:
    """The macros of a flow kernel's library for ``shape`` (a
    :class:`FlowShape`, or a flow channel count at the shipped WaveNet),
    its pitch instantiation with ``pitch`` (True, or the operand's width:
    :func:`pitch_size`), its bfloat16 build with ``bf16``: each of
    :data:`SHAPE_MACROS` that differs from the shipped shape's, and
    ``GLOW_PITCH_SIZE`` unless the width is the one the 160- or
    80-channel build takes by default (:data:`SHIPPED_PITCH_SIZE`)."""
    shape = as_shape(shape)
    ps = pitch_size(shape, pitch)
    sized = () if not ps or SHIPPED_PITCH_SIZE.get(shape.channels) == ps \
        else (f'GLOW_PITCH_SIZE={ps}',)
    return ((PITCH_BUILD if ps else ())
            + tuple(f'{macro}={getattr(shape, field)}'
                    for field, macro in SHAPE_MACROS
                    if getattr(shape, field) != getattr(SHIPPED_SHAPE, field))
            + sized + (BF16_BUILD if bf16 else ()))


def shape_tag(shape) -> str:
    """The part of a build's name that names its shape: ``''`` for the
    shipped one, ``'c80'`` for another flow width at the shipped WaveNet,
    ``'c16_ch16_l2_k5'`` for another WaveNet."""
    shape = as_shape(shape)
    if shape[1:] == SHIPPED_SHAPE[1:]:
        return '' if shape == SHIPPED_SHAPE else f'c{shape.channels}'
    return '_'.join(f'{prefix}{value}' for prefix, value in
                    zip(('c', 'ch', 'l', 'k'), shape))


def build_tag(shape, pitch) -> str:
    """The part of a launch count's name that names the build of ``shape``
    (with a pitch operand ``pitch``: True or its width): ``''`` for the
    shipped float32 build, ``'pitch'`` for its pitch instantiation,
    ``'c80'`` for the 80-channel build and ``'c80_pitch'`` for that build's
    pitch instantiation (its pitch operand 1 wide), ``'c200'``,
    ``'c16_ch16_l2_k5_pitch'``, ...; a pitch width other than
    :func:`default_pitch_size`'s is named, as ``'c160_pitch1'``."""
    shape = as_shape(shape)
    ps = pitch_size(shape, pitch)
    pitch_part = ('' if not ps else 'pitch'
                  if ps == default_pitch_size(shape.channels)
                  else f'pitch{ps}')
    tag = shape_tag(shape) or ('c160' if pitch_part not in ('', 'pitch')
                               else '')
    return '_'.join(part for part in (tag, pitch_part) if part)


# the weights a bfloat16 kernel takes rounded to bfloat16 (held in float32),
# as the TPU kernels' wrappers cast them; w_in and w_rs reach it in
# tensor_core_weights' bfloat16 layout
BF16_ROUNDED_KEYS = ('mix_t', 'w_start', 'w_end', 'w_pitch', 'w_start_pad',
                     'w_end_pad', 'w_pitch_pad')
# the weights a body reads as they lie whose WaveNet width it pads (the
# float32 body: all five; the ring body: b_start, b_rs and w_pitch, the
# others through its slices), copied once where the weights are packed
# under padded_key's name (padded_weights) where the width is not ch
PAD_KEYS = ('w_start', 'b_start', 'b_rs', 'w_end', 'w_pitch')


def padded_key(key: str) -> str:
    """The name of ``key``'s copy at a body's padded WaveNet width."""
    return f'{key}_pad'


WEIGHT_KEYS = ('an_logs', 'an_bias', 'mix_t', 'w_start', 'b_start', 'w_in',
               'w_rs', 'b_rs', 'w_end', 'b_end')
COUPLING_WEIGHT_KEYS = WEIGHT_KEYS[3:]         # the coupling's own
# w_in and w_rs as the kernels' tensor-core GEMMs read them
# (:func:`tensor_core_weights`); a pack may carry them beside the f32 ones
TC_KEYS = {'w_in': 'w_in_tc', 'w_rs': 'w_rs_tc'}
# passes of the kernels' TF32 products: 3 is the error-compensated 3xTF32
# (f32 accuracy), 1 a single TF32 pass (3 digits, kept for measuring)
TF32_PASSES = 3
# frames of a time tile of every flow kernel at the shipped shape (the
# float32 body's) but the bfloat16 builds of flow_step, flow_stack and
# coupling
TIME_TILE = geometry(SHIPPED_SHAPE)['time_tile']
# and of theirs (the ring body's: with the halo, one 64-row block of wgmma)
RING_TIME_TILE = geometry(SHIPPED_SHAPE, True)['time_tile']
# the ring body's weights (csrc/flow_ring.cuh::RingWeights): the five
# products' in ring_layout_bf16, in the kernel's slots of the weights whose
# layout they hold
RING_KEYS = {'mix_t': 'mix_ring', 'w_start': 'start_ring', 'w_in': 'in_ring',
             'w_rs': 'rs_ring', 'w_end': 'end_ring'}
# those of the coupling's own weights (no mixing)
COUPLING_RING_KEYS = tuple(RING_KEYS[key] for key in COUPLING_WEIGHT_KEYS
                           if key in RING_KEYS)
# what the 'modules' route hands the coupling of a flow step's pack
# (``models/decoder.py::FlowStep.forward``): the coupling's own weights,
# their tensor-core layout (the float32 build's), their ring slices (the
# bfloat16 build's) and GR's pitch weights, those of them the pack holds
COUPLING_PACK_KEYS = (*COUPLING_WEIGHT_KEYS, *TC_KEYS.values(),
                      *COUPLING_RING_KEYS, 'w_pitch',
                      *(padded_key(key) for key in PAD_KEYS))
# a ring slice's depth (flow_ring.cuh's kRingDepth: a 128-byte row of B a
# column), and the columns (rows of B) a warpgroup takes of a 1x1 conv
# (each output half padded to it) and of a WaveNet product, at the shipped
# shape (geometry gives them at any)
RING_DEPTH = geometry(SHIPPED_SHAPE, True)['ring_depth']
RING_HALF_SMALL = geometry(SHIPPED_SHAPE, True)['half_small']
RING_HALF_BIG = geometry(SHIPPED_SHAPE, True)['half_big']
# the sources whose bfloat16 builds run the ring body
RING_SOURCES = ('flow_step.cu', 'flow_stack.cu', 'coupling.cu')
# for measuring (tools/time_flow.py bars): the ring body's summing depth
# (GLOW_RING_SUM_DEPTH: 16, 64 or 0 for a product's whole depth), None the
# one csrc/flow_ring.cuh ships; set before the first bfloat16 launch
RING_SUM_DEPTH: Optional[int] = None
# the phases a tile of the ring body's timed instantiation clocks
# (csrc/flow_ring.cuh::RingPhase), in order
RING_PHASES = ('load (forward: ActNorm, mixing)', 'start conv',
               *(f'layer {i} {part}' for i in range(4)
                 for part in ('k-tap conv + gate', 'res/skip conv')),
               'skip sum + end conv', 'affine + store (reverse: mixing)')
# and a tile of the coupling's (csrc/coupling.cu's bfloat16 build): the same
# without ActNorm and the mixing
COUPLING_PHASES = ('load', *RING_PHASES[1:-1], 'affine + store')
# what a launch over the live tiles reports when asked (``tiles`` of
# :func:`_flow_step_kernel`, :func:`_coupling_kernel`,
# :func:`_flow_stack_kernel` and ``coupling_grad._apply_kernels``;
# csrc/flow_common.cuh::report_tiles): the list's live items and all its
# items, the live tiles the blocks computed (summed over the launches that
# share the report), the most one block computed, the grid's blocks
TILE_COUNTS = ('live', 'items', 'computed', 'rounds', 'blocks')


# the launch counts' names of the 160- and 80-channel builds (flow width,
# pitch, bf16): ``launches``, ``pitch_launches``, ...,
# ``bf16_c80_pitch_launches``, after ``<what>_`` where there is one; every
# other build's count is made at its first launch (:func:`count_launches`)
COUNT_SUFFIXES = tuple('_'.join(part for part in (
    bf16, build_tag(c, pitch), 'launches') if part)
    for bf16 in ('', 'bf16') for c in BUILT_CHANNELS
    for pitch in (False, True))


def count_suffix(shape, pitch, bf16: bool = False) -> str:
    """The launch count's name of a build after ``<what>_``:
    ``'launches'``, ``'bf16_c200_pitch_launches'``, ..."""
    return '_'.join(part for part in ('bf16' if bf16 else '',
                                      build_tag(shape, pitch), 'launches')
                    if part)


def count_launches(fn, what: str, shape, pitch, count: int = 1,
                   bf16: bool = False) -> None:
    """Add ``count`` to the launch count of the build of ``shape`` (a
    :class:`FlowShape` or a flow channel count; with ``pitch``, at
    bfloat16 with ``bf16``) on ``fn``: ``fn.<what>_<suffix>`` with
    :func:`count_suffix` (``<what>_launches``, ``<what>_pitch_launches``,
    ``<what>_c80_launches``, ``<what>_bf16_c200_pitch_launches``, ...; no
    ``what_`` where ``what`` is empty)."""
    suffix = count_suffix(shape, pitch, bf16)
    name = f'{what}_{suffix}' if what else suffix
    setattr(fn, name, getattr(fn, name, 0) + count)


def zero_launch_counts(fn, what: str = '') -> None:
    """Set every build's launch count of ``what`` on ``fn`` to 0: those of
    :data:`COUNT_SUFFIXES` and any other build's that has counted."""
    prefix = f'{what}_' if what else ''
    names = {prefix + suffix for suffix in COUNT_SUFFIXES}
    names.update(name for name in vars(fn)
                 if name.startswith(prefix) and name.endswith('launches'))
    for name in names:
        setattr(fn, name, 0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tensor_core_layout(w: torch.Tensor) -> torch.Tensor:
    """``w [..., K, N]`` (K, N multiples of 8) split into TF32 halves ``hi =
    tf32_round(w)`` and ``lo = w − hi`` (exact in f32, ``hi + lo == w``) and
    laid out as the kernels' ``mma.sync.m16n8k8`` B fragments read them:
    ``[..., K/8, N/8, 32, 4]``, lane ``4g + t`` of the 8 × 8 block ``(kb,
    nb)`` holding ``(hi[8kb + t, 8nb + g], hi[8kb + t + 4, 8nb + g], lo[8kb
    + t, 8nb + g], lo[8kb + t + 4, 8nb + g])``."""
    *lead, k, n = w.shape
    # k = 8 kb + 4 h + t, n = 8 nb + g  ->  [kb, nb, g, t, h]
    blocks = w.reshape(*lead, k // 8, 2, 4, n // 8, 8)
    d = len(lead)
    blocks = blocks.permute(*range(d), d, d + 3, d + 4, d + 2, d + 1)
    hi = tf32_round(blocks.contiguous())
    pairs = torch.cat([hi, blocks - hi], dim=-1)
    return pairs.reshape(*lead, k // 8, n // 8, 32, 4).contiguous()


def tensor_core_layout_bf16(w: torch.Tensor) -> torch.Tensor:
    """``w [..., K, N]`` (K a multiple of 16, N of 8) rounded to bfloat16
    and laid out as the bfloat16 kernels' ``mma.sync.m16n8k16`` B fragments
    read them: ``[..., K/16, N/8, 32, 4]`` bfloat16, lane ``4g + t`` of the
    16 × 8 block ``(kb, nb)`` holding ``w[16kb + 2t + e, 8nb + g]`` for e in
    (0, 1, 8, 9), so that its two 32-bit registers are the pairs (2t, 2t+1)
    and (2t+8, 2t+9) of column g."""
    *lead, k, n = w.shape
    # k = 16 kb + 8 h + 2 t + e, n = 8 nb + g  ->  [kb, nb, g, t, h, e]
    blocks = w.reshape(*lead, k // 16, 2, 4, 2, n // 8, 8)
    d = len(lead)
    blocks = blocks.permute(*range(d), d, d + 4, d + 5, d + 2, d + 1, d + 3)
    return blocks.to(torch.bfloat16).reshape(*lead, k // 16, n // 8, 32,
                                             4).contiguous()


def ring_layout_bf16(w: torch.Tensor, half_rows: int) -> torch.Tensor:
    """``w [..., K, N]`` (N even, ``N / 2 <= half_rows``) rounded to
    bfloat16 and laid out as the ring body stages it (``csrc/flow_ring.cuh``):
    ``[..., S, 2 half_rows, D]``, the depth padded with zeros to ``S``
    slices of ``D`` = :data:`RING_DEPTH`.  Slice ``s`` is the B operand of
    ``wgmma`` for the depths ``D s ..``, K-major: row ``n`` holds column
    ``h N/2 + j`` of ``w`` for ``n = h half_rows + j`` (``j < N/2``; the
    rest of each half zero), its 16-byte chunk ``c`` (depths ``D s + 8 c
    ..``) stored at chunk ``c ^ (n % 8)`` of the row: the 128-byte swizzle
    (``bf16_mma.cuh::sw128``), so that one bulk copy stages a slice as it
    lies.  A permutation of ``w``'s values and zeros."""
    *lead, k, n = w.shape
    half = n // 2
    chunks = RING_DEPTH // 8
    depth = -(-k // RING_DEPTH) * RING_DEPTH
    rows = w.new_zeros((*lead, depth, 2, half_rows), dtype=torch.float32)
    rows[..., :k, :, :half] = w.float().reshape(*lead, k, 2, half)
    rows = rows.reshape(*lead, depth // RING_DEPTH, chunks, 8, 2 * half_rows)
    d = len(lead)
    # [..., slice, chunk, element, row] -> [..., slice, row, chunk, element]
    rows = rows.permute(*range(d), d, d + 3, d + 1, d + 2)
    row = torch.arange(2 * half_rows, device=w.device)[:, None]
    chunk = torch.arange(chunks, device=w.device)[None, :]
    # the chunk stored at c came from chunk c ^ (row % 8)
    swizzled = rows[..., row, chunk ^ (row % chunks), :]
    return swizzled.reshape(*lead, depth // RING_DEPTH, 2 * half_rows,
                            RING_DEPTH).to(torch.bfloat16).contiguous()


def pad_gate(w: torch.Tensor, ch_pad: int) -> torch.Tensor:
    """``w [..., 2ch]`` (a pre-gate's or res/skip's columns: two halves
    ``ch`` wide) with each half padded with zeros to ``ch_pad``:
    ``[..., 2 ch_pad]``, half ``h`` at ``h·ch_pad``."""
    ch = w.shape[-1] // 2
    halves = w.reshape(*w.shape[:-1], 2, ch)
    return F.pad(halves, (0, ch_pad - ch)).reshape(*w.shape[:-1], 2 * ch_pad)


def pad_rows(w: torch.Tensor, ch_pad: int, axis: int = -2) -> torch.Tensor:
    """``w`` with its ``axis`` (the WaveNet's ``ch`` channels) padded with
    zeros to ``ch_pad``."""
    axis %= w.dim()
    widths = [0, 0] * (w.dim() - 1 - axis) + [0, ch_pad - w.shape[axis]]
    return F.pad(w, widths)


def padded_wavenet(key: str, w: torch.Tensor, ch_pad: int) -> torch.Tensor:
    """The weight ``key`` of a flow step (any leading axes) at the WaveNet
    width ``ch_pad`` (``ch`` padded with zeros: every padded channel of h,
    the gate, the res/skip sum and the conditioning rows then stays an
    exact zero, tanh 0 · σ 0 = 0, and z and the logdet are the unpadded
    computation's): ``w_start [C/2, ch]`` and ``b_start [ch]`` along their
    last axis, ``w_end [ch, C]`` along its rows, ``w_in [n, k, ch, 2ch]``
    and ``w_rs [n, ch, 2ch]`` along both, ``b_rs``, ``w_pitch`` and the
    conditioning rows (``[..., 2ch]``) half by half; the rest as it is."""
    if key in ('w_start', 'b_start'):
        return pad_rows(w, ch_pad, -1)
    if key == 'w_end':
        return pad_rows(w, ch_pad)
    if key in ('w_in', 'w_rs'):
        return pad_gate(pad_rows(w, ch_pad), ch_pad)
    if key in ('b_rs', 'w_pitch', 'cond'):
        return pad_gate(w, ch_pad)
    return w


def ring_half(n: int) -> int:
    """The rows of B a warpgroup takes of a 1x1 conv with ``n`` output
    columns (two halves): each half padded to 96, or to 192 where it is
    wider (C/2 up to 128 in the envelope)."""
    return 96 * -(-(n // 2) // 96)


def ring_weights(weights: Weights) -> Dict[str, torch.Tensor]:
    """The ring body's weights (:data:`RING_KEYS`) of those among
    ``mix_t``, ``w_start``, ``w_in`` (gate columns interleaved), ``w_rs``
    and ``w_end`` that ``weights`` hold, any leading axes (a stack of flow
    steps), in :func:`ring_layout_bf16`: the WaveNet at the ring body's
    width (:func:`geometry`'s ``ch_pad``, 192: :func:`padded_wavenet`), the
    mixing's and the end conv's output halves each padded to
    :func:`ring_half` columns, the start conv's to 96 and the WaveNet
    products' :data:`RING_HALF_BIG` wide.  Computed without gradient."""
    ch_pad = RING_HALF_BIG
    with torch.no_grad():
        out = {}
        for key, name in RING_KEYS.items():
            if key not in weights:
                continue
            w = padded_wavenet(key, weights[key].float(), ch_pad)
            half = {'mix_t': ring_half(w.shape[-1]), 'w_start': ch_pad // 2,
                    'w_in': ch_pad, 'w_rs': ch_pad,
                    'w_end': ring_half(w.shape[-1])}[key]
            if key == 'w_in':
                w = interleave_gate(w)
            out[name] = ring_layout_bf16(w, half)
        return out


def ring_shapes(c: int, n: int, k: int, ch: int) -> Dict[str, tuple]:
    """The shapes of one flow step's :func:`ring_weights` at ``c`` flow
    channels and the WaveNet's ``n`` layers of ``k`` taps, ``ch`` wide (at
    the ring body's width :data:`RING_HALF_BIG`, whatever ``ch``)."""
    g = geometry(FlowShape(c, ch, n, k), True)
    depth, ch_pad = g['ring_depth'], g['ch_pad']

    def slices(d):
        return -(-d // depth)
    small, big = 2 * g['half_small'], 2 * g['half_big']
    return {'mix_ring': (slices(c), small, depth),
            'start_ring': (slices(c // 2), ch_pad, depth),
            'in_ring': (n, slices(k * ch_pad), big, depth),
            'rs_ring': (n, slices(ch_pad), big, depth),
            'end_ring': (slices(ch_pad), small, depth)}


def interleave_gate(w_in: torch.Tensor) -> torch.Tensor:
    """``w_in [..., k, ch, 2ch]`` → ``[..., k·ch, 2ch]`` with the pre-gate
    columns interleaved: column ``2c`` is tanh column ``c``, ``2c + 1``
    sigmoid column ``ch + c``, so the thread that holds one holds the
    other."""
    *lead, k, ch, ch2 = w_in.shape
    w = w_in.reshape(*lead, k * ch, 2, ch2 // 2)
    return w.transpose(-1, -2).reshape(*lead, k * ch, ch2)


def tensor_core_weights(w_in: torch.Tensor, w_rs: torch.Tensor,
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """The kernels' ``w_in`` (gate columns interleaved) and ``w_rs`` in
    :func:`tensor_core_layout` (in :func:`tensor_core_layout_bf16` for the
    bfloat16 builds, ``dtype`` bfloat16), under :data:`TC_KEYS`' names;
    ``w_in [..., n, k, ch, 2ch]``, ``w_rs [..., n, ch, 2ch]``, any leading
    axes (a stack of flow steps), the WaveNet at the float32 body's width
    (``ch`` padded to a multiple of 64: :func:`padded_wavenet`).  Computed
    without gradient: the kernels have none."""
    layout = (tensor_core_layout if dtype == torch.float32
              else tensor_core_layout_bf16)
    ch_pad = body_width(w_rs.shape[-2])
    with torch.no_grad():
        w_in = padded_wavenet('w_in', w_in.float(), ch_pad)
        w_rs = padded_wavenet('w_rs', w_rs.float(), ch_pad)
        return {'w_in_tc': layout(interleave_gate(w_in)),
                'w_rs_tc': layout(w_rs)}


def padded_weights(weights: Weights, ch_pad: int) -> Weights:
    """The kernel's copies (``<key>_pad``, :data:`PAD_KEYS`) of those of
    ``weights`` that a body reads as they lie, at the WaveNet width
    ``ch_pad`` (:func:`padded_wavenet`), where that is not ``ch``; none
    where it is.  Computed without gradient."""
    if weights['b_start'].shape[-1] == ch_pad:
        return {}
    with torch.no_grad():
        return {padded_key(key): padded_wavenet(key, weights[key].float(),
                                                ch_pad).contiguous()
                for key in PAD_KEYS if key in weights}


def with_tensor_core_weights(weights: Weights,
                             dtype: torch.dtype = torch.float32) -> Weights:
    """``weights`` with :func:`tensor_core_weights` of ``dtype`` added,
    unless they carry them already (a pack caches them), and the padded
    copies the float32 body reads (:func:`padded_weights`); for bfloat16
    also with :data:`BF16_ROUNDED_KEYS` rounded to it, without
    gradient."""
    tc_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    if all(key in weights and weights[key].dtype == tc_dtype
           for key in TC_KEYS.values()):
        return weights
    ch_pad = body_width(weights['w_rs'].shape[-2])
    return rounded_weights({**weights, **tensor_core_weights(
        weights['w_in'], weights['w_rs'], dtype),
        **padded_weights(weights, ch_pad)}, dtype)


def with_kernel_weights(weights: Weights, dtype: torch.dtype) -> Weights:
    """``weights`` (a flow step's or the coupling's own, float32) as the
    deterministic kernels of ``dtype`` take them, without gradient: at
    float32 with :func:`tensor_core_weights` (and :func:`padded_weights`),
    at bfloat16 with :data:`BF16_ROUNDED_KEYS` rounded, the ring body's
    slices (:func:`ring_weights`) of the products it holds and the padded
    copies at its width, as ``FlowStep.weights`` packs them."""
    if dtype == torch.float32:
        return with_tensor_core_weights(weights)
    return rounded_weights({**weights, **ring_weights(weights),
                            **padded_weights(weights, RING_HALF_BIG)}, dtype)


def rounded_weights(weights: Weights, dtype: torch.dtype) -> Weights:
    """``weights`` with :data:`BF16_ROUNDED_KEYS` rounded to ``dtype``,
    without gradient, as a bfloat16 kernel takes them (``weights`` as they
    are at float32)."""
    if dtype == torch.float32:
        return weights
    with torch.no_grad():
        return {**weights, **{key: rounded(weights[key].float(), dtype)
                              for key in BF16_ROUNDED_KEYS if key in weights}}


def kernel_keys(keys) -> Tuple[str, ...]:
    """``keys`` as a kernel takes them: ``w_in`` and ``w_rs`` in the
    tensor-core layout."""
    return tuple(TC_KEYS.get(key, key) for key in keys)


def valid_lengths(mask: torch.Tensor) -> torch.Tensor:
    """int ``[B]``: one past the last frame of each sample whose mask
    ``[B, T, 1]`` is not zero (the sample's length, for a prefix mask)."""
    b, t = mask.shape[:2]
    frames = torch.arange(1, t + 1, device=mask.device)
    return ((mask.reshape(b, t) != 0) * frames).amax(dim=1)


def live_tile_schedule(lengths, t: int, tile: int = TIME_TILE):
    """The work list of a launch that computes valid tiles only
    (``csrc/flow_common.cuh::LiveTiles``): ``(sample, tile, live)`` items,
    the live tiles (first owned frame below the sample's length) sample by
    sample first, then the dead ones.  A grid of G blocks gives block i the
    items i, i + G, …; ``ceil(live / G)`` rounds of live tiles."""
    n_tiles = -(-t // tile)
    lengths = [int(n) for n in lengths]
    live = [(b, i, True) for b, n in enumerate(lengths)
            for i in range(-(-n // tile))]
    dead = [(b, i, False) for b, n in enumerate(lengths)
            for i in range(-(-n // tile), n_tiles)]
    return live + dead


class StackItem(NamedTuple):
    """An item of :func:`stack_tile_schedule`: flow step ``step`` (in launch
    order: on the inverse pass step 0 runs the last flow step) on tile
    ``tile`` of sample ``sample``, or, where ``live`` is False, that dead
    tile's zeroing, which stands for every step; ``after`` holds the
    positions in the list of the items it waits for."""
    step: int
    sample: int
    tile: int
    live: bool
    after: Tuple[int, ...]


def stack_tile_schedule(lengths, t: int, steps: int,
                        tile: int = TIME_TILE) -> List[StackItem]:
    """The work list of the one-launch stack (``csrc/flow_stack.cu``): first
    the dead tiles of :func:`live_tile_schedule` (zeroed in both buffers,
    for every step), then ``(step, live tile)`` for each step in turn, the
    live tiles in :func:`live_tile_schedule`'s order.  Step ``j + 1`` on
    tile ``i`` waits for step ``j`` on tiles ``i − 1``, ``i`` and ``i + 1``
    of the sample (for a dead one, its zeroing): the tiles whose rows its
    halo reads.  A grid of G blocks gives block g the items g, g + G, …:
    at most ``ceil(steps · live / G)`` live items a block."""
    tiles = live_tile_schedule(lengths, t, tile)
    dead = [(b, i) for b, i, live in tiles if not live]
    items = [StackItem(0, b, i, False, ()) for b, i in dead]
    # where each tile's latest item stands: its zeroing, or its last step
    latest = {tile_id: n for n, tile_id in enumerate(dead)}
    n_tiles = -(-t // tile)
    for j in range(steps):
        step_items = {}
        for b, i, live in tiles:
            if not live:
                continue
            after = () if j == 0 else tuple(
                latest[(b, n)] for n in (i - 1, i, i + 1) if 0 <= n < n_tiles)
            step_items[(b, i)] = len(items)
            items.append(StackItem(j, b, i, True, after))
        latest.update(step_items)
    return items


def tap_conv(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The WaveNet's k-tap convolution over time, padded to keep ``T``:
    ``h [B, T, i]``, ``w [k, i, o]`` → ``[B, T, o]``, one float32 product
    of ``h`` shifted by each tap.  Products follow torch's matmul precision
    (float32 unless a caller lowers it); cuDNN's convolution would take
    TF32 on a card by default."""
    k, t = w.shape[0], h.shape[1]
    pad = (k - 1) // 2
    hp = F.pad(h, (0, 0, pad, k - 1 - pad))
    out = hp[:, :t] @ w[0]
    for j in range(1, k):
        out = out + hp[:, j:j + t] @ w[j]
    return out


def wavenet_stats(x_a: torch.Tensor, mask: torch.Tensor, weights: Weights,
                  cond: Optional[torch.Tensor],
                  pitch: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32, *,
                  b_in: Optional[torch.Tensor] = None,
                  drop: Optional[Callable[[int], torch.Tensor]] = None,
                  world=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coupling network: start 1×1 → n gated layers → end 1×1.
    ``x_a [B, T, C/2]``; layer ``i``'s conv output gets ``b_in [n, 2ch]``
    (the train route's packs carry it apart), is multiplied by the dropout
    mask ``drop(i)`` and gets ``cond [n, B, 2ch]`` (the deterministic
    routes' rows hold the in-conv bias too).  Returns ``(mean, logs)``,
    each ``[B, T, C/2]`` float32.  At bfloat16 ``dtype`` the operands of
    every product are rounded to it where the TPU kernel casts them
    (``glow_tts_tpu/ops/coupling.py::_coupling_body``).

    Under ``world`` with a model group of M ranks (``parallel/tp.py``) the
    hidden stream ``h`` lives sharded: ``w_start [C/2, ch/M]``, ``b_start``
    and ``w_in [n, k, ch/M, 2ch]`` are this rank's slices, each layer's
    conv partials are summed over the group in float32 before the bias,
    and the gate, ``res_skip`` and the skip sum are whole."""
    def r(v):
        return rounded(v, dtype)

    def rw(name, i=None):
        w = weights[name] if i is None else weights[name][i]
        return rounded_weight(w, dtype)

    n = weights['w_in'].shape[0]
    ch = weights['w_in'].shape[-1] // 2
    h = r((copy_to_model(r(x_a), world) @ rw('w_start')
           + weights['b_start']) * mask)
    skip = 0.0
    for i in range(n):
        acc = reduce_from_model(tap_conv(h, rw('w_in', i)), world)
        if b_in is not None:
            acc = acc + b_in[i]
        if drop is not None:
            acc = acc * drop(i)
        if cond is not None:
            acc = acc + r(cond[i])[:, None, :]
        if pitch is not None:
            acc = acc + r(pitch) @ rw('w_pitch', i)
        gate = r(torch.tanh(acc[..., :ch]) * torch.sigmoid(acc[..., ch:]))
        rs = gate @ rw('w_rs', i) + weights['b_rs'][i]
        if i < n - 1:
            h = r((h + scatter_to_model(rs[..., :ch], 2, world)) * mask)
        skip = skip + rs[..., ch:]
    out = r(skip * mask) @ rw('w_end') + weights['b_end']
    return out.chunk(2, dim=-1)


def flow_step_reference(x: torch.Tensor, mask: torch.Tensor,
                        weights: Weights, cond: torch.Tensor,
                        reverse: bool = False,
                        pitch: Optional[torch.Tensor] = None, world=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch flow step, the same function as the kernel.

    ``x [B, T, C]``, ``mask [B, T, 1]``; ``weights`` as
    ``glow_tts_tpu.ops.coupling.fused_flow_step`` takes them
    (``an_logs``/``an_bias [C]``, ``mix_t [C, C]``, ``ld_const`` (forward),
    ``w_start [C/2, ch]``, ``b_start [ch]``, ``w_in [n, k, ch, 2ch]``,
    ``w_rs [n, ch, 2ch]`` with the last layer's res half zero,
    ``b_rs [n, 2ch]``, ``w_end [ch, C]``, ``b_end [C]``).
    Returns ``(z [B, T, C], logdet [B] | None)``, ``z`` in ``x``'s dtype
    (float32 or bfloat16, the module docstring's policy), the logdet
    float32.  Under ``world`` the WaveNet runs sharded over its model
    group (:func:`wavenet_stats`)."""
    dtype = x.dtype
    c2 = x.shape[-1] // 2
    an_logs, an_bias = weights['an_logs'], weights['an_bias']
    mix_t = rounded_weight(weights['mix_t'], dtype)
    x = x.float()
    if reverse:
        x_a, x_b = x[..., :c2], x[..., c2:]
    else:
        y = (an_bias + torch.exp(an_logs) * x) * mask
        y = (rounded(y, dtype) @ mix_t) * mask
        x_a, x_b = rounded(y[..., :c2], dtype), y[..., c2:]
    mean, logs = wavenet_stats(x_a, mask, weights, cond, pitch, dtype,
                               world=world)
    if reverse:
        z_b = (x_b - mean) * torch.exp(-logs) * mask
        y = (rounded(torch.cat([x_a, z_b], dim=-1), dtype) @ mix_t) * mask
        return ((y - an_bias) * torch.exp(-an_logs) * mask).to(dtype), None
    z_b = (mean + torch.exp(logs) * x_b) * mask
    logdet = ((logs * mask).sum(dim=(1, 2))
              + weights['ld_const'] * mask.sum(dim=(1, 2)))
    return torch.cat([x_a, z_b], dim=-1).to(dtype), logdet


def coupling_reference(x_a: torch.Tensor, x_b: torch.Tensor,
                       mask: torch.Tensor, weights: Weights,
                       cond: torch.Tensor,
                       pitch: Optional[torch.Tensor] = None,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch affine coupling, the same function as the kernel.

    ``x_a``, ``x_b [B, T, C/2]`` (the WaveNet reads ``x_a``),
    ``mask [B, T, 1]``; ``weights`` as
    ``glow_tts_tpu.ops.coupling.fused_coupling`` takes them (those of
    :func:`flow_step_reference` without ``an_logs``, ``an_bias``, ``mix_t``
    and ``ld_const``).  Returns ``(z_b [B, T, C/2], logdet [B] | None)``,
    ``z_b`` in ``x_b``'s dtype (at bfloat16 the module docstring's
    policy)."""
    dtype = x_b.dtype
    mean, logs = wavenet_stats(x_a.float(), mask, weights, cond, pitch,
                               dtype)
    x_b = x_b.float()
    if reverse:
        return ((x_b - mean) * torch.exp(-logs) * mask).to(dtype), None
    return (((mean + torch.exp(logs) * x_b) * mask).to(dtype),
            (logs * mask).sum(dim=(1, 2)))


def flow_stack_reference(x: torch.Tensor, mask: torch.Tensor,
                         weights: Weights, cond: torch.Tensor,
                         pitch: Optional[torch.Tensor] = None,
                         reverse: bool = False, world=None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch flow stack, the same function as the kernel: a loop of
    :func:`flow_step_reference` (under ``world``, sharded as it is).

    ``weights`` are those of :func:`flow_step_reference`, each stacked
    along a leading axis of ``S`` flow steps (``ld_const [S]``, forward),
    as ``glow_tts_tpu.ops.coupling.fused_flow_stack`` takes them;
    ``cond [S, n, B, 2ch]``.  The inverse pass runs the steps ``S − 1 … 0``.
    Returns ``(z [B, T, C], logdet [B] summed over the steps | None)``."""
    steps = weights['w_in'].shape[0]
    logdet = None if reverse else torch.zeros(x.shape[0], device=x.device)
    for s in (reversed(range(steps)) if reverse else range(steps)):
        x, ld = flow_step_reference(
            x, mask, {key: value[s] for key, value in weights.items()},
            cond[s], reverse, pitch, world)
        if ld is not None:
            logdet = logdet + ld
    return x, logdet


def _weight_shapes(c: int, n: int, k: int, ch: int,
                   dtype: torch.dtype = torch.float32) -> Dict[str, tuple]:
    """The shapes of one flow step's weights at the WaveNet width ``ch``:
    those of ``WEIGHT_KEYS``, the tensor-core layout of ``w_in`` and
    ``w_rs`` (a kernel of ``dtype`` reads 8- or, in bfloat16, 16-deep
    blocks) and the padded copies (:data:`PAD_KEYS`)."""
    depth = 8 if dtype == torch.float32 else 16
    return {'an_logs': (c,), 'an_bias': (c,), 'mix_t': (c, c),
            'w_start': (c // 2, ch), 'b_start': (ch,),
            'w_in': (n, k, ch, 2 * ch), 'w_rs': (n, ch, 2 * ch),
            'w_in_tc': (n, k * ch // depth, ch // 4, 32, 4),
            'w_rs_tc': (n, ch // depth, ch // 4, 32, 4),
            **{padded_key(key): shape for key, shape in (
                ('w_start', (c // 2, ch)), ('b_start', (ch,)),
                ('b_rs', (n, 2 * ch)), ('w_end', (ch, c)))},
            'b_rs': (n, 2 * ch), 'w_end': (ch, c), 'b_end': (c,)}


def _check_launch(name: str, x: torch.Tensor,
                  tensors: Dict[str, Tuple[torch.Tensor, tuple]],
                  views: Optional[Dict[str, Tuple[torch.Tensor,
                                                  tuple]]] = None,
                  dtypes: Optional[Dict[str, torch.dtype]] = None,
                  load_bytes: int = 16) -> None:
    """What every kernel of this module asks of a CUDA call: no tensor that
    requires grad, and each of ``tensors`` (name → (tensor, shape)) a
    contiguous tensor of its shape on ``x``'s device, float32 unless
    ``dtypes`` names another for it.  ``views`` (of ``dtypes`` too) may be
    slices of a wider tensor's channels: unit stride along the channels,
    every other stride and the address a multiple of ``load_bytes``, the
    width of the build's loads of a half (:func:`half_load_bytes`: 16
    bytes, or 8 or 4 where a half's rows are not a multiple of 16 bytes).
    Raises otherwise."""
    views = views or {}
    dtypes = dtypes or {}
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    if torch.is_grad_enabled() and any(
            tensor.requires_grad
            for tensor, _ in (*tensors.values(), *views.values())):
        raise RuntimeError(
            f'{name}: the CUDA kernel has no backward; run it under '
            'torch.no_grad() or on detached tensors, or train through '
            'ops.coupling_grad.flow_stack_train')
    for key, (tensor, shape) in tensors.items():
        dtype = dtypes.get(key, torch.float32)
        if (tensor.device != x.device or tensor.dtype != dtype
                or tuple(tensor.shape) != tuple(shape)
                or not tensor.is_contiguous()):
            raise ValueError(
                f'{name}: {key} must be a contiguous {dtype} tensor of '
                f'shape {tuple(shape)} on {x.device}; got '
                f'{tuple(tensor.shape)} {tensor.dtype} on {tensor.device}')
    for key, (view, shape) in views.items():
        dtype = dtypes.get(key, torch.float32)
        # a load's elements at this dtype
        chunk = load_bytes // view.element_size()
        if (view.device != x.device or view.dtype != dtype
                or tuple(view.shape) != tuple(shape) or view.stride(-1) != 1
                or any(stride % chunk for stride in view.stride()[:-1])
                or view.data_ptr() % load_bytes):
            raise ValueError(
                f'{name}: {key} must be a {dtype} tensor of shape '
                f'{tuple(shape)} on {x.device} with unit stride along the '
                f'channels and rows aligned to {chunk} elements '
                f'({load_bytes} bytes); got {tuple(view.shape)} '
                f'{view.dtype} strides {view.stride()} at byte '
                f'{view.data_ptr() % load_bytes} of {load_bytes} on '
                f'{view.device}')


def half_load_bytes(channels: int, bf16: bool) -> int:
    """The bytes a build loads of a half's row at a time (``csrc/
    flow_ring.cuh::RingShape::VEC``; the float32 body's
    ``flow_common.cuh::kHalfVec`` floats): the widest of 16, 8 and 4 that
    divides a half's row of C/2 elements (16 at 160 channels; at bfloat16 8
    where C/2 ≡ 4 (mod 8), as at C = 200, and 4 where C/2 ≡ 2 (mod 4), as at
    C = 100, whose float32 halves load 8)."""
    row = (channels // 2) * (2 if bf16 else 4)
    return next(size for size in (16, 8, 4) if row % size == 0)


def check_shape(name: str, channels: int, w_in_shape: Tuple[int, ...],
                pitch_size: int = 0, bf16: Optional[bool] = None
                ) -> FlowShape:
    """The :class:`FlowShape` of ``channels`` flow channels and ``w_in [n,
    k, ch, 2ch]``, or raise naming ``ROADMAP.md`` B.2 unless the
    deterministic kernels build for it (:func:`check_envelope`; with
    ``bf16`` given, within a block's shared memory at that dtype and
    ``pitch_size``)."""
    return check_envelope(name, shape_of(channels, w_in_shape), pitch_size,
                          bf16)


def train_error(shape, bf16: bool, pitch: int = 0) -> Optional[str]:
    """Why no build of the train kernels (#5, #6) takes ``shape`` at
    bfloat16 (``bf16``) or float32 with a pitch operand ``pitch`` wide, or
    None where one does: the deterministic envelope
    (:func:`envelope_error`) and a pitch width that divides the channels,
    less what the train builds cannot take: a saved row ``ch`` wide that
    #5 stores and #6 stages 16 bytes at a time (ch a multiple of 4 at
    float32, of 8 at bfloat16) and more than :data:`TRAIN_MAX_LAYERS`
    layers.  #5's block fits at every such shape: where its saving stage
    has no room (ch 192 at 8 layers of 5 taps and C = 200, for one) it
    stores the gate halves from its registers (:func:`geometry` with
    ``train``: ``save_stage`` 0), and where w_pitch does not fit beside the
    buffers it reads w_pitch from global memory."""
    shape = as_shape(shape)
    why = envelope_error(shape)
    if why is None and pitch and shape.channels % pitch:
        why = (f'a pitch operand {pitch} wide (num_squeeze) does not '
               f'divide {shape.channels} channels')
    grain = 8 if bf16 else 4
    if why is None and shape.ch % grain:
        why = (f'ch {shape.ch}: the {"bfloat16" if bf16 else "float32"} '
               f'train builds store and read the saved rows {grain} '
               'channels at a time (a multiple of it)')
    if why is None and shape.n_layers > TRAIN_MAX_LAYERS:
        why = (f'{shape.n_layers} layers: the backward adds the gradients '
               f'of at most {TRAIN_MAX_LAYERS} in one launch')
    return why


def check_train_shape(name: str, channels: int, w_in_shape: Tuple[int, ...],
                      pitch_size: int = 0, bf16: bool = False) -> FlowShape:
    """The :class:`FlowShape` of ``channels`` flow channels and ``w_in [n,
    k, ch, 2ch]``, or raise naming ``ROADMAP.md`` B.2's train half unless
    the train kernels (#5, #6) build for it at bfloat16 (``bf16``) or
    float32 with a pitch operand ``pitch_size`` wide
    (:func:`train_error`).  Nothing falls back to the plain version on the
    card."""
    shape = shape_of(channels, w_in_shape)
    why = train_error(shape, bf16, pitch_size)
    if why is not None:
        raise ValueError(
            f'{name}: no build of the train kernels (#5, #6) takes '
            f'{shape}: {why} (other shapes: ROADMAP.md B.2, the train '
            'half)')
    return shape


def kernel_key(key: str, bf16: bool, padded: bool) -> str:
    """The name in a pack of what a kernel reads for ``key``: the ring
    body's slices (bfloat16), the tensor-core layout (float32), the padded
    copy where the body's WaveNet width is not ``ch``, or ``key``."""
    if bf16 and key in RING_KEYS:
        return RING_KEYS[key]
    if not bf16 and key in TC_KEYS:
        return TC_KEYS[key]
    if padded and key in PAD_KEYS:
        return padded_key(key)
    return key


def _check_weights(name: str, x: torch.Tensor, pitch, channels: int,
                   weights: Weights,
                   tensors: Dict[str, Tuple[torch.Tensor, tuple]],
                   keys: Tuple[str, ...], steps: Optional[int] = None,
                   views=None, dtypes=None,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[Dict[str, str], Dict[str, int]]:
    """:func:`_check_launch` on ``tensors`` (of ``dtypes``) and on what the
    kernel of ``dtype`` reads of the weights ``keys`` (with ``ld_const``:
    one a step, forward), after :func:`check_shape` at that dtype: the
    ring body's :func:`ring_weights` (bfloat16) or the tensor-core layout
    (float32) of its products, the padded copies
    (:func:`padded_weights`) where its WaveNet width is not ``ch``, the
    rest as they are.  ``weights`` must carry them: they are made once,
    where the weights are packed, not at every launch.  With a ``pitch [B,
    T, ps]`` operand (``ps`` num_squeeze), ``weights`` carry ``w_pitch
    [(S,) n, ps, 2ch]`` too.  Returns ``(names, geometry)``: each key's
    name in the pack (:func:`kernel_key`), ``w_pitch`` among them with a
    pitch operand, and the build's :func:`geometry`."""
    w_in_shape = weights['w_in'].shape[0 if steps is None else 1:]
    lead = () if steps is None else (steps,)
    ps = 0 if pitch is None else pitch.shape[-1]
    bf16 = dtype != torch.float32
    shape = check_shape(name, channels, w_in_shape, ps, bf16)
    g = geometry(shape, bf16, ps)
    c, ch, n, k = shape
    padded = g['ch_pad'] != ch
    keys = tuple(keys)
    tensors = dict(tensors)
    if pitch is not None:
        if 'w_pitch' not in weights:
            raise ValueError(f'{name}: a pitch operand needs w_pitch among '
                             'the weights')
        b, t = tensors['mask'][1][:2]
        tensors['pitch'] = (pitch, (b, t, ps))
        keys += ('w_pitch',)
    names = {key: kernel_key(key, bf16, padded) for key in keys}
    # the shapes of one step's weights at the body's WaveNet width
    shapes = {**_weight_shapes(c, n, k, g['ch_pad'], dtype),
              'w_pitch': (n, ps, 2 * g['ch_pad']), 'ld_const': ()}
    if bf16:
        shapes.update(ring_shapes(c, n, k, ch))
    missing = [names[key] for key in keys if names[key] not in weights]
    if missing:
        raise ValueError(
            f'{name}: the weights lack {missing}; lay them out once where '
            'the weights are packed (with_kernel_weights; FlowStep.weights '
            'caches them)')
    kernel_dtypes = {**dict.fromkeys(RING_KEYS.values(), torch.bfloat16),
                     **dict.fromkeys(TC_KEYS.values(), torch.float32
                                     if not bf16 else torch.bfloat16),
                     **(dtypes or {})}
    _check_launch(name, x, {
        **tensors,
        **{names[key]: (weights[names[key]],
                        lead + shapes[names[key] if names[key] in shapes
                                      else key])
           for key in keys}}, views, kernel_dtypes,
        half_load_bytes(c, bf16))
    return names, g


def kernel_cond(cond: torch.Tensor, ch_pad: int) -> torch.Tensor:
    """The conditioning rows ``[..., 2ch]`` as a body of WaveNet width
    ``ch_pad`` reads them: each half padded with zeros (a copy) where
    that is not ``ch``."""
    if cond.shape[-1] == 2 * ch_pad:
        return cond
    return padded_wavenet('cond', cond, ch_pad).contiguous()


def tile_report(device) -> torch.Tensor:
    """Zeroed ints for a launch over the live tiles to report into
    (:data:`TILE_COUNTS`), for measuring."""
    return torch.zeros(len(TILE_COUNTS), dtype=torch.int32, device=device)


def tile_report_pointer(name: str, tiles: Optional[torch.Tensor],
                        x: torch.Tensor) -> Optional[int]:
    """The address of ``tiles`` (:func:`tile_report` on ``x``'s device), or
    None (NULL: no report)."""
    if tiles is None:
        return None
    if (tiles.device != x.device or tiles.dtype != torch.int32
            or tuple(tiles.shape) != (len(TILE_COUNTS),)
            or not tiles.is_contiguous()):
        raise ValueError(f'{name}: tiles must be tile_report({x.device})')
    return tiles.data_ptr()


def _pitch_pointers(pitch: Optional[torch.Tensor], weights: Weights,
                    names: Dict[str, str]
                    ) -> Tuple[Optional[int], Optional[int]]:
    """The addresses of the pitch operand and of the kernel's ``w_pitch``
    (its name in ``names``), or NULLs."""
    if pitch is None:
        return None, None
    return pitch.data_ptr(), weights[names['w_pitch']].data_ptr()


def _raise_on(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           + lib.glow_cuda_error_string(err).decode())


def _rounded_operands(cond: torch.Tensor, pitch: Optional[torch.Tensor],
                      dtype: torch.dtype):
    """``(cond, pitch)`` as a build of ``dtype`` takes them: at bfloat16 the
    conditioning rows and the pitch operand rounded to it (held in
    float32), as the TPU kernel's wrapper casts them."""
    if dtype == torch.float32:
        return cond, pitch
    return (rounded(cond, dtype).contiguous(),
            None if pitch is None else rounded(pitch, dtype).contiguous())


def flow_step(x: torch.Tensor, mask: torch.Tensor, weights: Weights,
              cond: torch.Tensor, reverse: bool = False,
              pitch: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One flow step: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor.  Arguments and result as
    :func:`flow_step_reference`; on the card ``weights`` carry
    :func:`tensor_core_weights` too (a pack caches them)."""
    if x.device.type == 'cpu':
        return flow_step_reference(x, mask, weights, cond, reverse, pitch)
    return _flow_step_kernel(x, mask, weights, cond, reverse, pitch)


def _flow_step_kernel(x, mask, weights, cond, reverse=False, pitch=None,
                      passes: int = TF32_PASSES,
                      tiles: Optional[torch.Tensor] = None,
                      clocks: Optional[torch.Tensor] = None):
    """:func:`flow_step`'s launch, with the TF32 passes of its products
    (1 for measuring; a bfloat16 build has one bfloat16 pass and takes 3)
    and, for measuring, a :func:`tile_report` to fill.  A bfloat16 ``x``
    goes to the bfloat16 build (the ring body, on :func:`ring_weights`),
    with the conditioning rows and the pitch operand rounded to bfloat16
    here, as the TPU kernel's wrapper casts them.  ``clocks`` (bfloat16
    only, for measuring: :func:`flow_step_phases`) launches the timed
    instantiation, which no launch count counts."""
    b, t, c = x.shape
    n, k, ch, ch2 = weights['w_in'].shape
    bf16 = x.dtype == torch.bfloat16
    dtype = x.dtype if bf16 else torch.float32
    names, g = _check_weights(
        'flow_step', x, pitch, c, weights, {
            'x': (x, (b, t, c)), 'mask': (mask, (b, t, 1)),
            'cond': (cond, (n, b, ch2))},
        WEIGHT_KEYS + (() if reverse else ('ld_const',)),
        dtypes={'x': dtype}, dtype=dtype)
    shape = FlowShape(c, ch, n, k)
    if passes not in (1, 3) or (bf16 and passes != 3):
        raise ValueError(f'flow_step: passes is 1 or 3 (3 at bfloat16), '
                         f'got {passes}')
    if (clocks is not None or passes == 1) and shape not in SHIPPED_SHAPES:
        raise ValueError('flow_step: the measuring instantiations (one TF32 '
                         'pass, the timed one) are built at the shipped '
                         f'shapes {[tuple(s) for s in SHIPPED_SHAPES]}')
    if clocks is not None and not bf16:
        raise ValueError('flow_step: the timed instantiation is the '
                         'bfloat16 build\'s')
    tiles_ptr = tile_report_pointer('flow_step', tiles, x)
    cond, pitch = _rounded_operands(cond, pitch, dtype)
    cond = kernel_cond(cond, g['ch_pad'])
    ps = 0 if pitch is None else pitch.shape[-1]

    lib = load_flow_step_library(ps, shape, bf16)
    z = torch.empty_like(x)
    ld_part = ld_ptr = part_ptr = None          # NULL: unused on reverse
    if not reverse:
        # per-(sample, time tile) partial logdets, summed below: no atomics,
        # so the result does not depend on block order
        n_tiles = -(-t // lib.glow_flow_step_time_tile())
        ld_part = torch.empty((b, n_tiles), device=x.device)
        ld_ptr = weights['ld_const'].data_ptr()
        part_ptr = ld_part.data_ptr()
    inputs = [x, mask, cond] + [weights[names[key]] for key in WEIGHT_KEYS]
    pointers = [*[p.data_ptr() for p in inputs[:3]],
                *_pitch_pointers(pitch, weights, names),
                *[p.data_ptr() for p in inputs[3:]], ld_ptr, z.data_ptr(),
                part_ptr, tiles_ptr, b, t, int(reverse)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if clocks is not None:
        _raise_on('flow_step', lib, lib.glow_flow_step_timed(
            *pointers, stream, clocks.data_ptr()))
    else:
        _raise_on('flow_step', lib, lib.glow_flow_step_f32(
            *pointers, passes, stream))
        count_launches(flow_step, '', shape, ps, bf16=bf16)
    return z, (None if ld_part is None else ld_part.sum(dim=1))


def flow_step_phases(x, mask, weights, cond, reverse=False, pitch=None):
    """The bfloat16 ``flow_step``'s timed instantiation (a CUDA bfloat16
    ``x``; not counted): ``(z, logdet, phases)``, ``phases`` the mean
    cycles a computed tile spends in each of :data:`RING_PHASES`, the
    tiles and rounds the launch reports, and the SM clock in GHz (cycles
    over ``%globaltimer`` ns, over the blocks' whole runs)."""
    lib = load_flow_step_library(
        0 if pitch is None else pitch.shape[-1],
        shape_of(x.shape[-1], weights['w_in'].shape), True)
    return _phases('flow_step', lib, x.device, x.shape[0], RING_PHASES,
                   lambda tiles, clocks: _flow_step_kernel(
                       x, mask, weights, cond, reverse, pitch, tiles=tiles,
                       clocks=clocks))


zero_launch_counts(flow_step)


def coupling(x_a: torch.Tensor, x_b: torch.Tensor, mask: torch.Tensor,
             weights: Weights, cond: torch.Tensor,
             pitch: Optional[torch.Tensor] = None, reverse: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The affine coupling alone: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Arguments and result as
    :func:`coupling_reference`.  On the card ``x_a`` and ``x_b`` may be the
    two halves of one ``[B, T, C]`` tensor, read where they lie; ``weights``
    carry :func:`tensor_core_weights` too (at bfloat16 the ring body's
    slices: :func:`with_kernel_weights`)."""
    if x_a.device.type == 'cpu':
        return coupling_reference(x_a, x_b, mask, weights, cond, pitch,
                                  reverse)
    return _coupling_kernel(x_a, x_b, mask, weights, cond, pitch, reverse)


def _coupling_kernel(x_a, x_b, mask, weights, cond, pitch=None,
                     reverse=False, tiles: Optional[torch.Tensor] = None,
                     clocks: Optional[torch.Tensor] = None):
    """:func:`coupling`'s launch, with, for measuring, a
    :func:`tile_report` to fill.  A bfloat16 ``x_a`` (and ``x_b``) goes to
    the bfloat16 build (the ring body, on the coupling's
    :data:`COUPLING_RING_KEYS`), as in :func:`_flow_step_kernel`.
    ``clocks`` (bfloat16 only, for measuring: :func:`coupling_phases`)
    launches the timed instantiation, which no launch count counts."""
    b, t, c2 = x_a.shape
    n, k, ch, ch2 = weights['w_in'].shape
    bf16 = x_a.dtype == torch.bfloat16
    dtype = x_a.dtype if bf16 else torch.float32
    names, g = _check_weights(
        'coupling', x_a, pitch, 2 * c2, weights,
        {'mask': (mask, (b, t, 1)), 'cond': (cond, (n, b, ch2))},
        COUPLING_WEIGHT_KEYS,
        views={'x_a': (x_a, (b, t, c2)), 'x_b': (x_b, (b, t, c2))},
        dtypes={'x_a': dtype, 'x_b': dtype}, dtype=dtype)
    shape = FlowShape(2 * c2, ch, n, k)
    if clocks is not None and not bf16:
        raise ValueError('coupling: the timed instantiation is the '
                         'bfloat16 build\'s')
    if clocks is not None and shape not in SHIPPED_SHAPES:
        raise ValueError('coupling: the timed instantiation is built at the '
                         f'shipped shapes {[tuple(s) for s in SHIPPED_SHAPES]}')
    tiles_ptr = tile_report_pointer('coupling', tiles, x_a)
    cond, pitch = _rounded_operands(cond, pitch, dtype)
    cond = kernel_cond(cond, g['ch_pad'])
    ps = 0 if pitch is None else pitch.shape[-1]

    lib = load_coupling_library(ps, shape, bf16)
    z_b = torch.empty((b, t, c2), device=x_a.device, dtype=dtype)
    ld_part = None                              # NULL: unused on reverse
    if not reverse:
        n_tiles = -(-t // lib.glow_coupling_time_tile())
        ld_part = torch.empty((b, n_tiles), device=x_a.device)
    pointers = [
        x_a.data_ptr(), x_a.stride(0), x_a.stride(1),
        x_b.data_ptr(), x_b.stride(0), x_b.stride(1),
        mask.data_ptr(), cond.data_ptr(),
        *_pitch_pointers(pitch, weights, names),
        *[weights[names[key]].data_ptr() for key in COUPLING_WEIGHT_KEYS],
        z_b.data_ptr(), None if ld_part is None else ld_part.data_ptr(),
        tiles_ptr, b, t, int(reverse)]
    stream = torch.cuda.current_stream(x_a.device).cuda_stream
    if clocks is not None:
        _raise_on('coupling', lib, lib.glow_coupling_timed(
            *pointers, stream, clocks.data_ptr()))
    else:
        _raise_on('coupling', lib, lib.glow_coupling_f32(*pointers, stream))
        count_launches(coupling, '', shape, ps, bf16=bf16)
    return z_b, (None if ld_part is None else ld_part.sum(dim=1))


def _phases(name: str, lib, device, batch: int, phases: Tuple[str, ...],
            launch) -> tuple:
    """The timed instantiation of a bfloat16 ring build (``lib``'s
    ``glow_<name>_resident_blocks`` and ``_clock_slots``): ``launch(tiles,
    clocks)`` fills a :func:`tile_report` and the blocks' clocks and
    returns ``(z, logdet)``; returns ``(z, logdet, report)``, the report
    the mean cycles a computed tile spends in each of ``phases``, the tiles
    and rounds the launch reports, and the SM clock in GHz (cycles over
    ``%globaltimer`` ns, over the blocks' whole runs)."""
    blocks = getattr(lib, f'glow_{name}_resident_blocks')(batch)
    if blocks < 0:
        raise RuntimeError(f'{name}: ' + lib.glow_cuda_error_string(
            -blocks).decode())
    clocks = torch.zeros(
        (blocks, getattr(lib, f'glow_{name}_clock_slots')()),
        dtype=torch.int64, device=device)
    tiles = tile_report(device)
    z, ld = launch(tiles, clocks)
    torch.cuda.synchronize(device)
    report = dict(zip(TILE_COUNTS, tiles.tolist()))
    sums = clocks.sum(dim=0).tolist()
    # the slots past the phases: a block's cycles, then its ns
    n = len(RING_PHASES)
    return z, ld, {
        'cycles': {phase: sums[i] / max(report['computed'], 1)
                   for i, phase in enumerate(phases)},
        'tiles': report['computed'], 'rounds': report['rounds'],
        'sm_ghz': sums[n] / max(sums[n + 1], 1)}


def coupling_phases(x_a, x_b, mask, weights, cond, pitch=None,
                    reverse=False):
    """The bfloat16 ``coupling``'s timed instantiation (CUDA bfloat16
    halves; not counted): ``(z_b, logdet, phases)``, ``phases`` as
    :func:`flow_step_phases`' over :data:`COUPLING_PHASES`."""
    lib = load_coupling_library(
        0 if pitch is None else pitch.shape[-1],
        shape_of(2 * x_a.shape[-1], weights['w_in'].shape), True)
    return _phases('coupling', lib, x_a.device, x_a.shape[0],
                   COUPLING_PHASES,
                   lambda tiles, clocks: _coupling_kernel(
                       x_a, x_b, mask, weights, cond, pitch, reverse,
                       tiles=tiles, clocks=clocks))


zero_launch_counts(coupling)


def flow_stack(x: torch.Tensor, mask: torch.Tensor, weights: Weights,
               cond: torch.Tensor, pitch: Optional[torch.Tensor] = None,
               reverse: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All the flow steps in one launch: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments and result as
    :func:`flow_stack_reference`; on the card ``weights`` carry
    :func:`tensor_core_weights` too (stacked)."""
    if x.device.type == 'cpu':
        return flow_stack_reference(x, mask, weights, cond, pitch, reverse)
    return _flow_stack_kernel(x, mask, weights, cond, pitch, reverse)


def _flow_stack_kernel(x, mask, weights, cond, pitch=None, reverse=False,
                       tiles: Optional[torch.Tensor] = None):
    """:func:`flow_stack`'s launch, with, for measuring, a
    :func:`tile_report` to fill (its live items are the steps times the
    live tiles).  A bfloat16 ``x`` goes to the bfloat16 build, as in
    :func:`_flow_step_kernel`, and the stream between the steps is
    bfloat16."""
    b, t, c = x.shape
    steps, n, k, ch, ch2 = weights['w_in'].shape
    bf16 = x.dtype == torch.bfloat16
    dtype = x.dtype if bf16 else torch.float32
    names, g = _check_weights(
        'flow_stack', x, pitch, c, weights, {
            'x': (x, (b, t, c)), 'mask': (mask, (b, t, 1)),
            'cond': (cond, (steps, n, b, ch2))},
        WEIGHT_KEYS + (() if reverse else ('ld_const',)), steps=steps,
        dtypes={'x': dtype}, dtype=dtype)
    shape = FlowShape(c, ch, n, k)
    tiles_ptr = tile_report_pointer('flow_stack', tiles, x)
    cond, pitch = _rounded_operands(cond, pitch, dtype)
    cond = kernel_cond(cond, g['ch_pad'])
    ps = 0 if pitch is None else pitch.shape[-1]

    lib = load_flow_stack_library(ps, shape, bf16)
    n_tiles = -(-t // lib.glow_flow_stack_time_tile())
    # the steps go to and fro between two buffers (a step's neighbours may
    # still be reading its input), the last one into z
    z = torch.empty_like(x)
    other = torch.empty_like(x) if steps > 1 else None
    # a flag per (step, sample, tile), zeroed by the launch
    done = torch.empty(steps * b * n_tiles, dtype=torch.int32,
                       device=x.device)
    ld_part = ld_ptr = None                     # NULL: unused on reverse
    if not reverse:
        # per-(sample, time tile) logdets, added over the steps in the
        # kernel and over the tiles below, in a fixed order
        ld_part = torch.empty((b, n_tiles), device=x.device)
        ld_ptr = weights['ld_const'].data_ptr()
    inputs = [x, mask, cond] + [weights[names[key]] for key in WEIGHT_KEYS]
    _raise_on('flow_stack', lib, lib.glow_flow_stack_f32(
        *[p.data_ptr() for p in inputs[:3]],
        *_pitch_pointers(pitch, weights, names),
        *[p.data_ptr() for p in inputs[3:]], ld_ptr, z.data_ptr(),
        None if other is None else other.data_ptr(),
        None if ld_part is None else ld_part.data_ptr(), done.data_ptr(),
        tiles_ptr, b, t, steps, int(reverse),
        torch.cuda.current_stream(x.device).cuda_stream))
    count_launches(flow_stack, '', shape, ps, bf16=bf16)
    return z, (None if ld_part is None else ld_part.sum(dim=1))


zero_launch_counts(flow_stack)


def load_flow_library(source: str, pitch=False, channels=SHIPPED_CHANNELS,
                      bf16: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the flow kernel source ``csrc/
    <source>`` for ``channels`` (a :class:`FlowShape`, or a flow channel
    count at the shipped WaveNet; its pitch instantiation with ``pitch``:
    True or the operand's width, :func:`pitch_size`; its bfloat16 build
    with ``bf16``, the ring body's at :data:`RING_SUM_DEPTH` where that is
    set), held to the width it reports and, for the sources that report
    their geometry (:data:`GEOMETRY_SOURCES`), to the :func:`geometry` it
    was compiled with (the train forward's, :data:`TRAIN_GEOMETRY_SOURCES`,
    with ``train``): raises on any difference."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    shape = as_shape(channels)
    defines = build_defines(shape, pitch, bf16)
    if bf16 and source in RING_SOURCES and RING_SUM_DEPTH is not None:
        defines += (f'GLOW_RING_SUM_DEPTH={RING_SUM_DEPTH}',)
    lib = load_library(source, defines)
    lib.glow_flow_channels.argtypes = []
    lib.glow_flow_channels.restype = ctypes.c_int
    if lib.glow_flow_channels() != shape.channels:
        raise RuntimeError(f'{source}: the library built for '
                           f'{shape.channels} channels reports '
                           f'{lib.glow_flow_channels()}')
    if source in GEOMETRY_SOURCES:
        ps = pitch_size(shape, pitch)
        want = {**shape._asdict(), 'pitch_size': ps,
                **geometry(shape, bf16, ps,
                           train=source in TRAIN_GEOMETRY_SOURCES)}
        got = library_geometry(lib)
        wrong = {key: (got[key], want[key]) for key in GEOMETRY_FIELDS
                 if got[key] != want[key]}
        if wrong:
            raise RuntimeError(
                f'{source} {" ".join(defines)}: the library\'s geometry '
                f'differs from ops/coupling.py::geometry\'s (field: '
                f'(library, Python)): {wrong}')
    return lib


def library_geometry(lib: ctypes.CDLL) -> Dict[str, int]:
    """What a deterministic flow library reports of its build
    (``glow_flow_geometry``: :data:`GEOMETRY_FIELDS`)."""
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    lib.glow_flow_geometry.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.glow_flow_geometry.restype = ctypes.c_int
    written = lib.glow_flow_geometry(out, len(GEOMETRY_FIELDS))
    if written != len(GEOMETRY_FIELDS):
        raise RuntimeError(f'the library reports {written} geometry fields, '
                           f'ops/coupling.py reads {len(GEOMETRY_FIELDS)}')
    return dict(zip(GEOMETRY_FIELDS, out))


def _load(source: str, entry: str, argtypes: list, pitch=False,
          channels=SHIPPED_CHANNELS,
          extra: Tuple[Tuple[str, list], ...] = (),
          bf16: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>`` for ``channels``
    flow channels, its pitch instantiation with ``pitch``, typed: its entry
    point, its time-tile query (and the other int queries in ``extra``, as
    (name, argtypes)) and the error-string function every library has."""
    lib = load_flow_library(source, pitch, channels, bf16)
    ci = ctypes.c_int
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = ci
    lib_tile = entry[:-len('f32')] + 'time_tile'
    getattr(lib, lib_tile).argtypes = []
    getattr(lib, lib_tile).restype = ci
    for query, argtypes in extra:
        getattr(lib, query).argtypes = argtypes
        getattr(lib, query).restype = ci
    lib.glow_cuda_error_string.argtypes = [ci]
    lib.glow_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_flow_step_library(pitch=False, channels=SHIPPED_CHANNELS,
                           bf16: bool = False) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = _load('flow_step.cu', 'glow_flow_step_f32',
                [vp] * (5 + len(WEIGHT_KEYS) + 4) + [ci, ci, ci, ci, vp],
                pitch, channels,
                extra=(('glow_flow_step_resident_blocks', [ci]),), bf16=bf16)
    if bf16:
        # the ring body's timed instantiation
        lib.glow_flow_step_timed.argtypes = (
            [vp] * (5 + len(WEIGHT_KEYS) + 4) + [ci, ci, ci, vp, vp])
        lib.glow_flow_step_timed.restype = ci
        lib.glow_flow_step_clock_slots.argtypes = []
        lib.glow_flow_step_clock_slots.restype = ci
    return lib


@functools.cache
def load_coupling_library(pitch=False, channels=SHIPPED_CHANNELS,
                          bf16: bool = False) -> ctypes.CDLL:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = ([vp, ll, ll] * 2 + [vp] * (4 + len(COUPLING_WEIGHT_KEYS) + 3)
            + [ci, ci, ci, vp])
    lib = _load('coupling.cu', 'glow_coupling_f32', args, pitch, channels,
                extra=(('glow_coupling_resident_blocks', [ci]),), bf16=bf16)
    if bf16:
        # the ring body's timed instantiation
        lib.glow_coupling_timed.argtypes = args + [vp]
        lib.glow_coupling_timed.restype = ci
        lib.glow_coupling_clock_slots.argtypes = []
        lib.glow_coupling_clock_slots.restype = ci
    return lib


@functools.cache
def load_flow_stack_library(pitch=False, channels=SHIPPED_CHANNELS,
                            bf16: bool = False) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load('flow_stack.cu', 'glow_flow_stack_f32',
                 [vp] * (5 + len(WEIGHT_KEYS) + 6) + [ci, ci, ci, ci, vp],
                 pitch, channels,
                 extra=(('glow_flow_stack_resident_blocks', [ci]),),
                 bf16=bf16)
