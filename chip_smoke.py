#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``glow_tts_tpu_torch/csrc`` (the flow step, the
coupling alone, the whole flow stack in one launch, the monotonic alignment
search, the train-direction flow stack's forward and its backward), holds
each against its plain PyTorch version at the shipped width, and drives
the port's paths through them at ``configs/Hyper_Parameters.yaml`` width
with random weights from a seed: Vanilla serving (``Inferencer``, two mel
buckets) and the loss/eval path (ActNorm's data-dependent initialisation on
a batch from ``TrainCollater``, then ``eval_step``), each under every
``coupling_backend`` route (``'fused'``, ``'modules'``, ``'mega'``), and
training (the same initialisation, then ``train_step`` a few times, beside
the same steps through the plain versions).  The backward is held against
autograd of the plain version under both of its routes (activations stored
by the forward pass, and recomputed), which must agree bit for bit, and
with one TF32 pass beside the shipped 3xTF32.  Times kernel and plain
versions with CUDA events, the backward's two GEMMs alone beside
``torch.matmul`` as a yardstick.  Last, the trainer: on pattern archives
it writes with the port's pattern IO (96 train, 40 eval patterns), run A
trains 4 steps and run B 2, then a new ``Trainer`` restores ``S_2.pt`` and
trains 2 more; A and B must agree within 1e-5 (cuDNN deterministic, as
``Trainer`` sets it), each part of the trainer's path must launch its
kernels, the checkpoint directory serves a TSV through ``Inferencer``, and
the data-fed loop (over a larger archive, inside one epoch) beside the
same batches copied and already on the card, both batch copies, a save
and an evaluation are timed.  Before the trainer, the conditioned modes
at the same width (``Mode`` GR, SE with the look-up table or GE2E, PE):
the pitch builds of the flow step, the coupling and the stack against
their plain versions and timed beside the Vanilla builds, GR served at
B = 32 in the 1024-frame bucket under each route, SE and PE served once
each, and the GR forward on the eval batch.  Then training in those
modes at the training shape: the pitch builds of the train forward and
backward against their plain version (every gradient, the pitch's
included, under both routes, bit-equal) and timed beside the Vanilla
builds, GR trained 4 steps through the kernels and through the plain
versions from the same weights, SE-LUT, SE-GE2E and PE 2 steps each, the
steps timed beside a Vanilla step on the same batch, and a GR ``Trainer``
resumed against its uninterrupted run.  Then MiniSpeech, the repo's
converged recipe (``configs/MiniSpeech.yaml``: ``Num_Squeeze: 1``, so 80
flow channels, the EM warmup and the decoder freeze) at its full width on
a batch of its shape (B = 32, tokens 5 … 40, frames 50 … 600, silent
frames where the pauses are): the 80-channel build of each flow kernel
against its plain version to the same bars and timed, 3 EM steps with
the decoder frozen, a released, an anchored and a linear step through
the kernels and through the plain versions (every MAS path equal), the
EM step timed beside a learned-prior MAS step, an eval step under each
route, and a ``Trainer`` with the warmup and the freeze over 2 of its 4
steps resumed from step 1 against its uninterrupted run.  Last, from wavs
to wavs: MiniSpeech's corpus (48 utterances from
``examples/make_minispeech.py``, a subprocess) through the port's ETL on
the card (4 patterns held against the same ETL on the CPU: the mel within
2e-3, the pitch equal outside its near-tie frames), the recipe's
``Trainer`` 6 steps on those patterns (#1, #5, #6 at 80 channels) and a
checkpoint, served through ``Inferencer`` with the Griffin-Lim export
twice (the wavs read back, bit-equal), Griffin-Lim on the card against
the CPU, SE-GE2E, PE and GR at the shipped width served from reference-wav
features made on the card (held against the CPU's), and the DSP and the
export timed.  Every phase named so far computes at float32 (each pins
``compute_dtype='float32'``, so its checks and timings compare with the
runs before the bfloat16 builds).  Between the conditioned training and
MiniSpeech, the bfloat16 phase runs the shipped YAMLs as shipped
(``TPU.compute_dtype: bfloat16``): the bf16 builds of #3, #5 and #6 (160
and 80 channels, and the pitch builds) against their bf16 plain versions,
the f32 plain version the reference (max|kernel - plain_bf16| <= 2
max|plain_bf16 - plain_f32| + 1e-6; gradients within 3e-2 norm-relative
of the f32 plain version's, and at most twice the bf16 plain version's
distance from them, plus 1e-4), #5's dropout masks counted element by
element, the routes bit-equal; the ActNorm init, 4 train steps and 2 eval steps under
'fused' at bf16 beside the same through the plain versions at bf16 and at
f32; the bf16 builds timed beside the f32 builds on the same inputs, with
their bounds at the bf16 peak; the train step at bf16 and at f32 on the
same batch by CUDA events and in a profiler window; a GR train step on the
bf16 pitch builds; and a MiniSpeech ``Trainer`` at bf16 on the 80-channel
bf16 builds.  Then bf16 under ``'modules'`` and ``'mega'``: the bf16 builds
of #3, #2 and #4 (the shipped YAML, MiniSpeech's 80 channels, GR's pitch
builds; all three run the Hopper body of ``csrc/flow_ring.cuh``)
against their bf16 plain versions (#4 also bit for bit against 12 × #3
bf16; #2's z_b and logdet bit for bit against #3 bf16's on an identity
ActNorm and mixing, and its tiles against its 48-frame schedule) and timed
beside their f32 builds, both directions, on the decode
and the eval batch's shapes, each beside its bound, the ActNorm init and two
eval steps under each route beside the plain versions at bf16 and f32 and
against 'fused', an ``Inferencer`` at ``inference_dtype`` bfloat16 under
each route at B = 32 in the 1024-frame bucket, the eval step at bf16 by
route.  Then GR at ``Num_Squeeze: 1`` (80 channels, the pitch operand 1
wide: the 80-channel pitch builds of #2–#6 at f32 and bf16 against
their plain versions and timed, 3 train steps at each dtype beside the
plain versions, an eval step under each route, a decode).  Then data
parallelism, each rank a process of this script (``--data-parallel-rank
KIND OUT`` with torchrun's environment): the shipped YAML at bf16 over
NCCL on every card, 3 steps of each rank's rows of a B = 32 batch,
bit-equal to one process in a world of one (on more cards at f32 with
dropout 0, to the train path's bars); then two ranks on card 0 over gloo
(NCCL refuses two ranks on one card), dropout 0, each on its own
collation of half the batch against one process at B = 32, at f32 to the
train path's bars and at bf16 (the gradients to the bf16 bar), and the
same for one 'em' step at MiniSpeech's config (its table included); each
rank's launches of #1, #5 and #6 and its step time by CUDA events.  Then
tensor parallelism: two ranks on card 0 over gloo as one model group
(data 1 × model 2, the same script's ranks, ``--data-parallel-rank tp``)
at the shipped widths, B = 8 (texts padded to 224 tokens, mels up to 512
frames), at f32 and at bf16 against one process on the same card through
the kernels: 2 train steps (losses, gradient norm, the weights after), an
eval step under 'fused' and a decode in the 512 bucket (durations equal,
then the mels), to ``tests/test_tp.py``'s bars at f32 and the port's bf16
bar at bf16; the replicated gradients and the MAS paths bit-equal across
the ranks, more than 30 % of the parameters sharded, each rank's launches
(#1 alone: no flow kernel runs under tensor parallelism), the model
group's collectives of a step and the step times.  Then data-parallel
serving (``--data-parallel-rank serve``): two ranks on card 0 over gloo
(data 2 × model 1) serve 32 items in one global batch (the 1024-frame
bucket) under 'fused' at f32 (with the Griffin-Lim export, each rank on
its own items) and at bf16, rank 0's gathered mels and the ranks'
log-durations held against one process on the same card (f32 mel MAE
within 1e-3, bf16 to the bf16 bar, at most one ceil flipped), each rank's
launches (12 ``flow_step`` a decode), the bytes gathered and the decode and
Griffin-Lim times beside one process's.  After the timings, ROADMAP C.5:
PyTorch's default flags (cuDNN's TF32 on) around the f32 prior phase and
an f32 eval step at the shipped widths, held against the port on the CPU
at 1e-4 of max-abs, the same reading through the library's ``F.conv1d``
shown past that bar, cuDNN's LSTM, GRU and Conv2d under those flags, and
the train step and prior phase timed with the shipped float32 taps, with
the library conv in TF32 and with it in float32.  The wav phase also
writes a few utterances as FLAC with the port's encoder: the native and
the pure decoders bit-equal, the ETL's mels from the FLAC files equal to
those from the WAVs, both decoders timed.  Last, what a user
reads of a run: which of tensorboardX, matplotlib and sklearn
import here; the shipped YAML as shipped (bf16) through ``Trainer`` at
B = 32, 4 steps with evaluations at 0, 2 and 4, the inference TSV at 4 and
``train(profile_steps=(1, 3))``, on its default ``SummaryLogger``s where
tensorboardX imports (their event files read back: tags, steps, counts)
and else on ``MemoryWriter``s after the default writers raise
``ImportError``: the images equal to the eval step's and the decode's
slices, a histogram of every parameter equal to it, a readable PNG per
sentence (or the one warning where matplotlib does not import), the
profiler's Chrome trace holding as many kernel events of #1, #5 and #6 as
their launch counters grew over the window; then PE's prosody check after
2 steps on an archive of 6 speakers × 8 utterances, its GST vectors held
against the same weights on the CPU at f32 (1e-4 of max-abs) and bf16
(twice the CPU's bf16-vs-f32 distance); an evaluation timed with and
without its images and histograms, the steps inside and outside the
window, the check per 100 mels.  After GR at ``Num_Squeeze: 1``, ROADMAP
B.2: every flow kernel at decoder shapes besides the shipped two (100-bin
mels, C = 200, with and without GR's pitch operand; ``tiny_config``'s
decoder, C 16, ch 16, 2 layers; a WaveNet of 16 layers of k 3, 128 wide),
each build at f32 and bf16: #3, #2 and #4 against their plain versions at
B = 32 x 512 and on the eval batch's ragged mask, #4 bit-equal to 12
chained #3 launches, #2 bf16 bit-equal to #3 bf16 on an identity, timed by
CUDA graph beside their bounds; the ActNorm init and an eval step under
each route; #5 (storing and not) and #6 against their plain versions on a
train step's operands at dropout 0.05 (the masks element by element, the
routes and two runs bit-equal), timed per flow step beside their bounds,
and a train step through them, counted; at C = 200 the losses against
the plain versions, the train step's losses and decoder gradients too
(Vanilla f32 and bf16, GR bf16) and 3 more steps, 32 items served in the
1024 bucket under each route at f32 and bf16; and a train step at a shape
no train build takes (C = 200 at 8 layers) refused with B.2's error.  All
81 libraries build together before the first phase.
Exits non-zero on any failure and when no CUDA device is present; the last
line is one JSON object naming the card.
"""

import contextlib
import copy
import dataclasses
import functools
import json
import logging
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'configs', 'Hyper_Parameters.yaml')
# bounds of kernel vs plain, both f32 (TF32 off): sums differ only in order
Z_REL_BOUND = 1e-4         # max |z_kernel - z_plain| / max |z_plain|
LD_REL_BOUND = 1e-5        # max |ld_kernel - ld_plain| / max |ld_plain|
ROUNDTRIP_BOUND = 1e-3     # max |reverse(forward(x)) - x| / max |x|
MEL_MAE_BOUND = 1e-3       # the repo's fidelity bar (BASELINE.md)
# the loss path, kernels vs plain versions, f32 on both sides
DDI_ABS_BOUND = 1e-4       # ActNorm logs/bias after data-dependent init
LOSS_REL_BOUND = 1e-4      # mle and duration loss of one eval batch
# the train-direction flow stack, kernels vs plain version and autograd of
# it, 12 steps at B=32, T=512, f32 on both sides: sums in another order
TRAIN_Z_REL_BOUND = 1e-4   # max |z_kernel - z_plain| / max |z_plain|
TRAIN_LD_REL_BOUND = 1e-5  # the same for the logdet
GRAD_REL_BOUND = 1e-4      # per gradient tensor, max |dk - dp| / max |dp|
# the shipped 3xTF32 products of #3 and #5 at least this many times closer
# to the plain version than one TF32 pass (which may pass the bars above)
ONE_PASS_MARGIN = 10
# the train path, kernels vs plain versions from the same weights, seed and
# generator state: per step
TRAIN_LOSS_REL_BOUND = 1e-4
TRAIN_NORM_REL_BOUND = 1e-3
TRAIN_STEPS = 4
FLOW_RATE = 0.05           # Decoder.Affine_Coupling.WaveNet.Dropout_Rate
# the trainer phase: pattern archives of 3 train batches an epoch (so 4
# steps cross an epoch and a resume at step 2 is mid-epoch) and an eval set
# of a full and a ragged batch; run A against 2 steps, a restore and 2 more
TRAIN_PATTERNS, EVAL_PATTERNS = 96, 40
TRAINER_STEPS, RESUME_STEP = 4, 2
SAVE_EVERY, EVAL_EVERY = 2, 4   # checkpoints and logs; evaluation, inference
RESUME_REL_BOUND = 1e-5    # A against B: max |a - b| / max |a| by group
FED_STEPS = 4              # the data-fed loop, after one warm-up step
TIMING_BATCHES = 6         # its archive's batches an epoch: a run in one
COPY_ITERS = 20
INFERENCE_TEXTS = ['The birch canoe slid on the smooth planks.',
                   'Glue the sheet to the dark blue background.',
                   'It is easy to tell the depth of a well.',
                   'These days a chicken leg is a rare dish.']
# kernels of csrc/flow_train_bwd.cu behind one flow step's backward, with or
# without conditioning: 11 activation-gradient and 11 weight-gradient GEMMs
# in 15 launches (7 of them a pair of one of each), 5 launches of column
# sums, the affine's elementwise backward and the reduction of all partials
BWD_KERNELS_PER_FLOW_STEP = 22
# and in its pitch build (GR mode): one more launch a layer, the pitch
# term's gradients
BWD_PITCH_KERNELS_PER_FLOW_STEP = 26
# the training shape of the shipped config: Train.Batch_Size 32, up to 200
# tokens and 1000 mel frames, padded to the 32-token and 128-frame buckets
EVAL_BATCH, MAX_TOKENS, MAX_FRAMES = 32, 200, 1000
EVAL_TOKENS, EVAL_FRAMES = 224, 1024       # the padded axes of such a batch
# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12   # dense, the tensor cores


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int, plain_iters: int = 0,
              plain_warmup: int = 3):
    """Plain, kernel, kernel, plain on the same card; mean of each pair."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(plain_fn, plain_iters, plain_warmup)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters, plain_warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(bytes_moved: float, flops: float,
          peak_flop_per_s: float = PEAK_F32_FLOP_PER_S):
    """The least time in ms the card could take: each input read once and
    each output written once at the memory rate, or the operations at the
    peak rate of the unit that does them (f32 FMA unless said), whichever
    is longer; and which of the two it is."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_flop_per_s * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


def body_bounds(moved, flops):
    """The bounds of a kernel that runs the flow step's body: its
    operations counted once at the TF32 peak of the tensor cores, which do
    all but 4 % of them, and, beside it, at the f32 FMA peak."""
    tf32_ms, tf32_by = bound(moved, flops, PEAK_TF32_FLOP_PER_S)
    fma_ms, fma_by = bound(moved, flops)
    return {'bound_ms': tf32_ms, 'bound_by': tf32_by,
            'fma_bound_ms': fma_ms, 'fma_bound_by': fma_by}


def live_tiles(mask, launch, steps=1, stack=False, tile=None):
    """What ``launch(tiles)`` reports from the card into ``tiles``
    (``coupling.TILE_COUNTS``: the list's live and all items, the live
    items computed, the rounds, the grid's blocks), held against the Python
    twin of its schedule: ``steps`` launches over the live tiles of the
    mask [B, T, 1] (``live_tile_schedule``), or, with ``stack``, the one
    launch over ``steps`` flow steps (``stack_tile_schedule``), at the time
    tile of the library launched (default: the float32 builds')."""
    from glow_tts_tpu_torch.ops import coupling
    tiles = coupling.tile_report(mask.device)
    launch(tiles)
    got = dict(zip(coupling.TILE_COUNTS, tiles.tolist()))
    lengths = coupling.valid_lengths(mask).tolist()
    if tile is None:
        tile = coupling.load_flow_step_library().glow_flow_step_time_tile()
    if stack:
        items = coupling.stack_tile_schedule(lengths, mask.shape[1], steps,
                                             tile)
        live = sum(item.live for item in items)
        computed = live
    else:
        items = coupling.live_tile_schedule(lengths, mask.shape[1], tile)
        live = sum(item[2] for item in items)
        computed = steps * live
    assert (got['live'], got['items']) == (live, len(items)), (got, live)
    assert got['computed'] == computed, got
    assert got['rounds'] == -(-live // got['blocks']), got
    return got


# the kernels' launch counters: (counter, wrapper's attribute prefix) of
# each flow source; each build counts apart (coupling.count_launches)
FLOW_COUNTERS = (('flow_step', ''), ('coupling', ''), ('flow_stack', ''),
                 ('train_fwd', 'forward_'), ('train_recompute', 'recompute_'),
                 ('train_bwd', 'backward_'))
# the deterministic decoder's routes (``config.coupling_backend``): the
# counter of the kernel each goes through
ROUTES = {'fused': 'flow_step', 'modules': 'coupling', 'mega': 'flow_stack'}
# the deterministic kernels' builds at other decoder shapes (ROADMAP B.2):
# label -> ((C, ch, layers, k), the pitch operand's width or 0); each a
# config of the shipped YAML with the overrides of B2_OVERRIDES
B2_SHAPES = {'c200': ((200, 192, 4, 5), 0),
             'c200_pitch': ((200, 192, 4, 5), 2),
             'c16_ch16_l2_k5': ((16, 16, 2, 5), 0),
             'c160_ch128_l16_k3': ((160, 128, 16, 3), 0),
             # 128-bin mels at Num_Squeeze 2; 100-bin mels at Num_Squeeze 1,
             # Vanilla and GR (the pitch operand 1 wide); 100-bin mels at 8
             # layers of the shipped WaveNet (#5 without its saving stage)
             'c256': ((256, 192, 4, 5), 0),
             'c100': ((100, 192, 4, 5), 0),
             'c100_pitch': ((100, 192, 4, 5), 1),
             'c200_l8': ((200, 192, 8, 5), 0)}
# what the B.2 phase runs of each build, where it is not every flow source
# at f32 and bf16 (the sources' counters: FLOW_COUNTERS' names): GR at
# Num_Squeeze 1, #3 at both dtypes (the init and an eval step under
# 'fused'; the f32 build also the baseline the bf16 one is timed beside)
# and a train step at bf16; C = 200 at 8 layers, #3 and a train step at
# both dtypes
B2_SOURCES = {'c100_pitch': {'flow_step': ('float32', 'bfloat16'),
                             'train_fwd': ('bfloat16',),
                             'train_bwd': ('bfloat16',)},
              'c200_l8': {'flow_step': ('float32', 'bfloat16'),
                          'train_fwd': ('float32', 'bfloat16'),
                          'train_bwd': ('float32', 'bfloat16')}}


def b2_builds(label):
    """{source's counter name: the dtypes ('float32', 'bfloat16') its
    build runs at} of B.2's ``label`` (B2_SOURCES, else every flow source at
    both)."""
    return B2_SOURCES.get(label, {
        name: ('float32', 'bfloat16') for name in (
            'flow_step', 'coupling', 'flow_stack', 'train_fwd', 'train_bwd')})


def launch_counters():
    """(function, attribute) of every kernel launch count of the port."""
    from glow_tts_tpu_torch.ops.coupling import (COUNT_SUFFIXES, coupling,
                                                 count_suffix, flow_stack,
                                                 flow_step)
    from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
    from glow_tts_tpu_torch.ops.mas import maximum_path
    fns = {'flow_step': flow_step, 'coupling': coupling,
           'flow_stack': flow_stack}
    counters = {'mas': (maximum_path, 'launches')}
    # one counter of each flow source per build (coupling.COUNT_SUFFIXES:
    # 'launches', 'pitch_launches', ..., 'bf16_c80_pitch_launches'), named
    # '<source>' + build_suffix(...)
    for suffix in COUNT_SUFFIXES:
        tag = suffix[:-len('launches')].rstrip('_')
        for name, what in FLOW_COUNTERS:
            counters[name + (f'_{tag}' if tag else '')] = (
                fns.get(name, flow_stack_train), what + suffix)
    # and every flow source's builds at the B.2 shapes
    for label, (shape, pitch) in B2_SHAPES.items():
        for bf16 in (False, True):
            suffix = count_suffix(shape, pitch, bf16)
            for name, what in FLOW_COUNTERS:
                counters[f'{name}_{suffix[:-len("_launches")]}'] = (
                    fns.get(name, flow_stack_train), what + suffix)
    return counters


def no_launches():
    """Every launch count of :func:`launch_counters` at 0."""
    return dict.fromkeys(launch_counters(), 0)


def build_suffix(config=None, channels=None, pitch=False, bf16=False):
    """The suffix of the counters of the flow build ``config`` (or a flow
    of ``channels`` channels) runs through: '' at the shipped 160, '_c80'
    at MiniSpeech's 80, with '_pitch' for a pitch operand and '_bf16'
    before those at bfloat16 ('_bf16_c80_pitch'); '_c200',
    '_c16_ch16_l2_k5', ... at the B.2 shapes."""
    from glow_tts_tpu_torch.ops.coupling import (build_tag, config_shape,
                                                 pitch_width)
    if channels is None:
        channels = config_shape(config)
        pitch = pitch and pitch_width(config)
    tag = build_tag(channels, pitch)
    return ('_bf16' if bf16 else '') + (f'_{tag}' if tag else '')


def route_launches(route, config, passes=1, pitch=False):
    """The flow launches of ``passes`` decoder passes under ``route``: one
    per flow step, or one in all under ``'mega'``, of the pitch
    instantiation with ``pitch`` (of the 80-channel build at
    ``Num_Squeeze: 1``, of the bfloat16 build at ``compute_dtype``
    bfloat16); every other count 0."""
    per_pass = 1 if route == 'mega' else config.decoder.stack
    counter = ROUTES[route] + build_suffix(
        config, pitch=pitch, bf16=config.compute_dtype == 'bfloat16')
    return {**no_launches(), counter: per_pass * passes}


def plain_flow_fns():
    """The plain versions of the three routes' functions, as the keyword
    arguments that swap them in."""
    from glow_tts_tpu_torch.ops.coupling import (
        coupling_reference, flow_stack_reference, flow_step_reference)
    return {'step_fn': flow_step_reference, 'coupling_fn': coupling_reference,
            'flow_stack_fn': flow_stack_reference}


def zero_counts():
    for fn, name in launch_counters().values():
        setattr(fn, name, 0)


def read_counts():
    torch.cuda.synchronize()
    return {key: getattr(fn, name)
            for key, (fn, name) in launch_counters().items()}


def step_frame_flops(weights) -> int:
    """Operations of one flow step on one valid frame: 2 per weight of the
    mixing (where the weights have one: the coupling alone does not), the
    start conv, the n k-tap convs and res/skip 1x1s and the end conv, less
    the last layer's res half, which is structurally zero."""
    ch = weights['w_rs'].shape[-2]
    return 2 * (sum(weights[key].numel() for key in
                    ('w_start', 'w_in', 'w_rs', 'w_end', 'mix_t')
                    if key in weights) - ch * ch)


def coupling_weights(weights):
    """The coupling's own of a flow step's packed weights, with their
    tensor-core layout (float32) or the ring body's slices (bfloat16)."""
    from glow_tts_tpu_torch.ops.coupling import COUPLING_PACK_KEYS
    return {key: weights[key] for key in COUPLING_PACK_KEYS
            if key in weights and key != 'w_pitch'}


def ragged_batch(gen, b, t, c, device):
    lengths = torch.linspace(1, t, b).round().long()
    lengths[0], lengths[-1] = 1, t
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = torch.randn((b, t, c), generator=gen) * mask
    return x.to(device), mask.to(device)


def check_kernel(model, device):
    """The kernel against its plain version at full width, both
    directions, ragged lengths (1 … T), T = 512 and an odd T."""
    from glow_tts_tpu_torch.ops.coupling import (_flow_step_kernel,
                                                 flow_step,
                                                 flow_step_reference)
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    gen = torch.Generator().manual_seed(SEED + 1)
    worst = 0.0
    precision = {}
    for t in (512, 333):
        x, mask = ragged_batch(gen, 32, t, c, device)
        cond = step.cond(32)
        for reverse in (False, True):
            w = step.weights(reverse)
            z_k, ld_k = flow_step(x, mask, w, cond, reverse)
            z_p, ld_p = flow_step_reference(x, mask, w, cond, reverse)
            torch.cuda.synchronize()
            err = (z_k - z_p).abs().max().item()
            rel = err / z_p.abs().max().item()
            line = (f'kernel vs plain  T={t} reverse={reverse}: '
                    f'max abs err {err:.3e}, max rel err {rel:.3e}')
            assert torch.isfinite(z_k).all(), 'kernel output not finite'
            assert rel < Z_REL_BOUND, line
            if not reverse:
                ld_rel = ((ld_k - ld_p).abs().max()
                          / ld_p.abs().max()).item()
                line += f', logdet rel err {ld_rel:.3e}'
                assert ld_rel < LD_REL_BOUND, line
            print(line)
            worst = max(worst, err)
            one, _ = _flow_step_kernel(x, mask, w, cond, reverse, passes=1)
            three_worst, one_worst = precision.get(reverse, (0.0, 0.0))
            precision[reverse] = (max(three_worst, rel),
                                  max(one_worst, rel_err(one, z_p)))
        z, _ = flow_step(x, mask, step.weights(False), cond, False)
        back, _ = flow_step(z, mask, step.weights(True), cond, True)
        trip = ((back - x).abs().max() / x.abs().max()).item()
        print(f'kernel round trip T={t}: max rel err {trip:.3e}')
        assert trip < ROUNDTRIP_BOUND
    for reverse, (three, one) in precision.items():
        line = (f'flow step precision reverse={reverse}: 3xTF32 shipped, z '
                f'max rel err {three:.3e}; 1xTF32 {one:.3e} (bar '
                f'{Z_REL_BOUND:.0e})')
        print(line)
        assert one > ONE_PASS_MARGIN * three, line
    return worst, max(one for _, one in precision.values())


def check_coupling(model, device):
    """Kernel #2 against its plain version at full width: B = 32, T = 512,
    ragged lengths (1 … T), both directions, the halves handed over as the
    decoder does (views of one tensor), and the round trip."""
    from glow_tts_tpu_torch.ops.coupling import coupling, coupling_reference
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    x, mask = ragged_batch(torch.Generator().manual_seed(SEED + 8), 32, 512,
                           c, device)
    x_a, x_b = x[..., :c // 2], x[..., c // 2:]
    w = coupling_weights(step.weights(False))
    cond = step.cond(32)
    worst = 0.0
    for reverse in (False, True):
        z_k, ld_k = coupling(x_a, x_b, mask, w, cond, reverse=reverse)
        z_p, ld_p = coupling_reference(x_a, x_b, mask, w, cond,
                                       reverse=reverse)
        torch.cuda.synchronize()
        err, rel = (z_k - z_p).abs().max().item(), rel_err(z_k, z_p)
        line = (f'coupling kernel vs plain T=512 reverse={reverse}: max abs '
                f'err {err:.3e}, max rel err {rel:.3e}')
        assert torch.isfinite(z_k).all(), 'kernel output not finite'
        assert rel < Z_REL_BOUND, line
        if not reverse:
            ld_rel = rel_err(ld_k, ld_p)
            line += f', logdet rel err {ld_rel:.3e}'
            assert ld_rel < LD_REL_BOUND, line
        print(line)
        worst = max(worst, err)
    z_b, _ = coupling(x_a, x_b, mask, w, cond)
    back, _ = coupling(x_a, z_b, mask, w, cond, reverse=True)
    trip = rel_err(back, x_b)
    print(f'coupling kernel round trip: max rel err {trip:.3e}')
    assert trip < ROUNDTRIP_BOUND
    return worst


def check_flow_stack(model, device):
    """Kernel #4 against its plain version at full width: all the model's
    flow steps at B = 32, T = 512, ragged lengths and all frames valid, both
    directions, the round trip, and its z bit for bit against a chain of
    flow-step launches (kernel #3), whose per-tile arithmetic it shares."""
    from glow_tts_tpu_torch.ops.coupling import (flow_stack,
                                                 flow_stack_reference,
                                                 flow_step)
    decoder = model.layer_Dict['Decoder']
    flows = list(decoder.layer_Dict['Flows'])
    c = flows[0].layers[0].logs.shape[1]
    x, mask = ragged_batch(torch.Generator().manual_seed(SEED + 9), 32, 512,
                           c, device)
    cond = decoder.stacked_cond(32)
    worst = 0.0
    for shape, m in (('ragged', mask), ('all valid', torch.ones_like(mask))):
        for reverse in (False, True):
            w = decoder.stacked_weights(reverse)
            z_k, ld_k = flow_stack(x, m, w, cond, reverse=reverse)
            z_p, ld_p = flow_stack_reference(x, m, w, cond, reverse=reverse)
            chained = x
            for step in (reversed(flows) if reverse else flows):
                chained, _ = flow_step(chained, m, step.weights(reverse),
                                       step.cond(32), reverse)
            torch.cuda.synchronize()
            err, rel = (z_k - z_p).abs().max().item(), rel_err(z_k, z_p)
            same = torch.equal(z_k, chained)
            line = (f'flow stack kernel vs plain, {len(flows)} steps, T=512 '
                    f'{shape} reverse={reverse}: max abs err {err:.3e}, max '
                    f'rel err {rel:.3e}; z bit-equal to {len(flows)} chained '
                    f'flow-step launches: {same}')
            assert torch.isfinite(z_k).all(), 'kernel output not finite'
            assert rel < Z_REL_BOUND, line
            assert same, line
            if not reverse:
                ld_rel = rel_err(ld_k, ld_p)
                line += f', logdet rel err {ld_rel:.3e}'
                assert ld_rel < LD_REL_BOUND, line
            print(line)
            worst = max(worst, err)
    z, _ = flow_stack(x, mask, decoder.stacked_weights(False), cond)
    back, _ = flow_stack(z, mask, decoder.stacked_weights(True), cond,
                         reverse=True)
    trip = rel_err(back, x)
    print(f'flow stack kernel round trip: max rel err {trip:.3e}')
    assert trip < ROUNDTRIP_BOUND
    return worst


def serve(inferencer, config, route='fused'):
    """The main path: text requests → Inferencer → mels, in two buckets,
    under the ``coupling_backend`` route the inferencer was built with."""
    requests = [
        ('short_a', 'The quick brown fox jumps over the lazy dog.', 1.0),
        ('short_b', 'Hello there, how are you today?', 1.0),
        ('long_a', 'Printing, in the only sense with which we are at '
                   'present concerned, differs from most if not from all '
                   'the arts and crafts represented in the exhibition.', 3.0),
        ('long_b', 'It was a bright cold day in April, and the clocks '
                   'were striking thirteen.', 4.0),
    ]
    labels, texts, scales = zip(*requests)
    n_decodes = -(-len(requests) // inferencer.batch_size)
    zero_counts()
    results = inferencer.inference(list(labels), list(texts), list(scales),
                                   seed=SEED)
    launches = read_counts()
    expected = route_launches(route, config, n_decodes)
    print(f'served {len(results)} requests in {n_decodes} decodes under '
          f'{route!r}: launches {launches} ({expected[ROUTES[route]]} '
          f'{ROUTES[route]} expected, nothing else)')
    assert inferencer.config.flow_route == route
    assert len(results) == len(requests)
    assert launches == expected, launches
    s = config.decoder.num_squeeze
    buckets = set()
    for r in results:
        mel, attn, bucket = r['mel'], r['attention'], r['bucket']
        n = mel.shape[0]
        print(f'  {r["label"]}: {attn.shape[0]} tokens → mel {mel.shape}, '
              f'bucket {bucket}')
        assert mel.shape[1] == config.sound.mel_dim
        assert n % s == 0 and s <= n <= bucket
        assert bucket in inferencer.mel_buckets
        assert torch.isfinite(torch.as_tensor(mel)).all(), r['label']
        # every kept frame belongs to exactly one token
        assert (attn.sum(axis=0) == 1).all(), r['label']
        buckets.add(bucket)
    assert len(buckets) >= 2, buckets
    return launches, results


def compare_served(served):
    """The same requests served under each route, same seed: every
    request's mel under ``'modules'`` and ``'mega'`` against ``'fused'``."""
    for route in ('modules', 'mega'):
        worst = 0.0
        for a, b in zip(served[route], served['fused']):
            assert a['label'] == b['label'] and a['mel'].shape == b['mel'].shape
            worst = max(worst, float(np.abs(a['mel'] - b['mel']).mean()))
        print(f'served mels, {route!r} vs \'fused\': worst mel MAE of a '
              f'request {worst:.3e}')
        assert worst < MEL_MAE_BOUND


def compare_decode(inferencer, texts, bucket):
    """One batch decoded through the route's kernel and through its plain
    version, same prior and noise: mel MAE over the valid frames."""
    from glow_tts_tpu_torch.text import text_filtering
    model = inferencer.model
    tokens, lengths, scales = inferencer.collate(
        [{'text': text_filtering(text)} for text in texts])
    prior = model.inference_prior(tokens, lengths, scales)
    gen = torch.Generator(device=inferencer.device).manual_seed(SEED + 2)
    noise = torch.randn((len(texts), bucket, model.config.sound.mel_dim),
                        generator=gen, device=inferencer.device)
    out_k = model.inference_decode(prior, noise=noise, max_mel_length=bucket)
    out_p = model.inference_decode(prior, noise=noise, max_mel_length=bucket,
                                   **plain_flow_fns())
    valid = (torch.arange(bucket, device=noise.device)[None, :]
             < out_k['mel_lengths'][:, None])[..., None]
    mae = ((out_k['mels'] - out_p['mels']).abs() * valid).sum() \
        / (valid.sum() * noise.shape[-1])
    print(f'decode under {inferencer.config.flow_route!r}, kernel vs plain '
          f'(B={len(texts)}, bucket {bucket}): mel MAE {mae.item():.3e}')
    assert mae.item() < MEL_MAE_BOUND


def time_flow_kernels(model, device, eval_mask, extras=True):
    """Kernels #3, #2 and #4 and their plain versions at B = 32, T = 512,
    both directions, each beside its bounds, with all frames valid and on
    the eval step's ragged mask ``eval_mask`` (the squeezed training batch),
    with the live tiles and rounds each kernel reports at both shapes; #3
    also at one TF32 pass; and the reverse stack three ways at both shapes:
    12 flow-step launches, the same launches replayed from a CUDA graph,
    and kernel #4's one launch, with the time of a round of each (the one
    TF32 pass and the reverse stack three ways only with ``extras``)."""
    from glow_tts_tpu_torch.ops.coupling import (
        TIME_TILE, WEIGHT_KEYS, _coupling_kernel, _flow_stack_kernel,
        _flow_step_kernel, coupling, coupling_reference, flow_stack,
        flow_stack_reference, flow_step, flow_step_reference, kernel_keys,
        load_coupling_library, load_flow_stack_library,
        load_flow_step_library)
    decoder = model.layer_Dict['Decoder']
    flows = list(decoder.layer_Dict['Flows'])
    n_steps = len(flows)
    step = flows[0]
    c = step.layers[0].logs.shape[1]
    # the eval batch's frames may outnumber the decode shape's 512
    # (MiniSpeech's 640 at Num_Squeeze 1)
    x, mask = ragged_batch(torch.Generator().manual_seed(SEED + 3),
                           32, max(512, eval_mask.shape[1]), c, device)
    # the same inputs on the eval step's ragged batch: live tiles only
    xe = x[:, :eval_mask.shape[1]].contiguous() * eval_mask
    x = x[:, :512].contiguous()
    mask = torch.ones_like(mask[:, :512])
    shapes = {'decode': (x, mask), 'eval': (xe, eval_mask)}
    cond = step.cond(32)
    stacked_cond = decoder.stacked_cond(32)
    weights = step.weights(False)
    own = coupling_weights(weights)
    stacked = {r: decoder.stacked_weights(r) for r in (False, True)}

    def weight_count(weights):
        # what the kernels read: w_in and w_rs in their tensor-core layout
        return sum(weights[key].numel()
                   for key in kernel_keys((*WEIGHT_KEYS, 'ld_const'))
                   if key in weights)

    def report(name, frame_flops, steps, moved, kernel_fn, plain_fn, iters):
        """Both shapes: the kernel and its plain version, both directions,
        beside the bounds of the work on the shape's valid frames (2 FLOP
        per live weight per valid frame and step, every tensor moved
        once); ``moved(x, mask)`` is the bytes, ``kernel_fn(x, mask,
        reverse)`` and ``plain_fn`` the calls."""
        out = {}
        for shape, (xs, m) in shapes.items():
            valid = m.sum().item()
            flops = frame_flops * valid * steps
            bounds = body_bounds(moved(xs, m), flops)
            label = ('B=32 T=512' if shape == 'decode' else
                     f'eval shape {tuple(xs.shape[:2])} ({int(valid)} valid '
                     f'frames)')
            times = {}
            for reverse in (True, False):
                k_ms, p_ms = paired_ms(lambda: kernel_fn(xs, m, reverse),
                                       lambda: plain_fn(xs, m, reverse),
                                       iters)
                print(f'{name} {label} reverse={reverse}: kernel {k_ms:.4f} '
                      f'ms ({flops / k_ms / 1e9:.2f} TFLOP/s at '
                      f'{frame_flops / 1e6:.2f} MFLOP/frame and step), plain '
                      f'{p_ms:.4f} ms; bound {bounds["bound_ms"]:.4f} ms by '
                      f'{bounds["bound_by"]} at the TF32 peak '
                      f'({bounds["fma_bound_ms"]:.4f} ms at the f32 FMA '
                      f'peak)')
                times[reverse] = (k_ms, p_ms)
            prefix = '' if shape == 'decode' else 'eval_shape_'
            out.update({f'{prefix}ms': times[True][0],
                        f'{prefix}plain_ms': times[True][1],
                        f'{prefix}forward_ms': times[False][0],
                        f'{prefix}forward_plain_ms': times[False][1]})
            if shape == 'decode':
                out.update(bounds)
            else:
                out['eval_shape_bound_ms'] = bounds['bound_ms']
        return out

    def schedules(name, launch, resident, steps=1, stack=False):
        """The tiles each shape's launch reports from the card, held against
        the twin, and the grid against the resident blocks."""
        out = {}
        for shape, (xs, m) in shapes.items():
            got = live_tiles(m, lambda tiles: launch(xs, m, tiles), steps,
                             stack)
            most = steps * m.shape[0] * -(-m.shape[1] // TIME_TILE) \
                if stack else got['items']
            assert got['blocks'] == min(resident(m.shape[0]), most), got
            out[shape] = {'live_tiles': got['computed'] // (
                              steps if stack else 1),
                          'tiles': got['items'], 'rounds': got['rounds'],
                          'blocks': got['blocks']}
            print(f'{name} live tiles, {shape} shape {tuple(m.shape[:2])}, '
                  f'as the kernel reports them: {got["computed"]} of '
                  f'{got["items"]} items computed, {got["rounds"]} rounds on '
                  f'{got["blocks"]} blocks')
        return out

    def step_bytes(xs, m):
        return 4 * (2 * xs.numel() + m.numel() + cond.numel() + xs.shape[0]
                    + weight_count(weights))

    flow_times = report(
        'flow step', step_frame_flops(weights), 1, step_bytes,
        lambda xs, m, r: flow_step(xs, m, step.weights(r), cond, r),
        lambda xs, m, r: flow_step_reference(xs, m, step.weights(r), cond,
                                             r), 20)
    # the same launches at one TF32 pass: what the two further passes cost
    for reverse in (True, False) if extras else ():
        one_ms = cuda_ms(lambda: _flow_step_kernel(
            x, mask, step.weights(reverse), cond, reverse, passes=1), 20)
        key = 'ms' if reverse else 'forward_ms'
        flow_times[f'one_pass_{key}'] = one_ms
        print(f'flow step B=32 T=512 reverse={reverse}, one TF32 pass: '
              f'kernel {one_ms:.4f} ms (3xTF32 {flow_times[key]:.4f} ms)')
    flow_times['schedule'] = schedules(
        'flow step', lambda xs, m, tiles: _flow_step_kernel(
            xs, m, weights, cond, False, tiles=tiles),
        load_flow_step_library(channels=c).glow_flow_step_resident_blocks)

    coupling_times = report(
        'coupling', step_frame_flops(own), 1,
        lambda xs, m: 4 * (xs.numel() + xs.numel() // 2 + m.numel()
                           + cond.numel() + xs.shape[0] + weight_count(own)),
        lambda xs, m, r: coupling(xs[..., :c // 2], xs[..., c // 2:], m, own,
                                  cond, reverse=r),
        lambda xs, m, r: coupling_reference(xs[..., :c // 2],
                                            xs[..., c // 2:], m, own, cond,
                                            reverse=r), 20)
    coupling_times['schedule'] = schedules(
        'coupling', lambda xs, m, tiles: _coupling_kernel(
            xs[..., :c // 2], xs[..., c // 2:], m, own, cond, tiles=tiles),
        load_coupling_library(channels=c).glow_coupling_resident_blocks)

    stack_times = report(
        f'flow stack ({n_steps} steps, one launch)',
        step_frame_flops(weights), n_steps,
        lambda xs, m: 4 * (2 * xs.numel() + m.numel() + stacked_cond.numel()
                           + xs.shape[0] + weight_count(stacked[False])),
        lambda xs, m, r: flow_stack(xs, m, stacked[r], stacked_cond,
                                    reverse=r),
        lambda xs, m, r: flow_stack_reference(xs, m, stacked[r],
                                              stacked_cond, reverse=r), 5)
    stack_times['schedule'] = schedules(
        'flow stack', lambda xs, m, tiles: _flow_stack_kernel(
            xs, m, stacked[False], stacked_cond, tiles=tiles),
        load_flow_stack_library(channels=c).glow_flow_stack_resident_blocks,
        steps=n_steps, stack=True)

    # the reverse stack as a decode runs it, three ways on the same input,
    # at both shapes; a round is one tile's step on every block
    packs = [(s.weights(True), s.cond(32)) for s in reversed(flows)]
    for shape, (xs, m) in shapes.items() if extras else ():
        def chain():
            y = xs
            for w, step_cond in packs:
                y, _ = flow_step(y, m, w, step_cond, True)
            return y

        eager = chain()                  # built and warm before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = chain()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), 'graph replay differs'

        def one_launch():
            return flow_stack(xs, m, stacked[True], stacked_cond,
                              reverse=True)

        assert torch.equal(one_launch()[0], eager)
        order = (chain, graph.replay, one_launch, one_launch, graph.replay,
                 chain)
        ms = [cuda_ms(fn, 5) for fn in order]
        chain_ms, graph_ms, stack_ms = ((ms[i] + ms[5 - i]) / 2
                                        for i in range(3))
        step_rounds = flow_times['schedule'][shape]['rounds']
        stack_rounds = stack_times['schedule'][shape]['rounds']
        chain_round = chain_ms / (n_steps * step_rounds)
        stack_round = stack_ms / stack_rounds
        print(f'reverse stack, {shape} shape {tuple(m.shape[:2])}, {n_steps} '
              f'steps: {n_steps} flow-step launches {chain_ms:.4f} ms '
              f'({n_steps} x {step_rounds} rounds, {chain_round:.4f} ms a '
              f'round), the same from a CUDA graph {graph_ms:.4f} ms, flow '
              f'stack in one launch {stack_ms:.4f} ms ({stack_rounds} rounds '
              f'on {stack_times["schedule"][shape]["blocks"]} blocks, '
              f'{stack_round:.4f} ms a round, {stack_round / chain_round:.3f}'
              f' x the flow step\'s); all three bit-equal')
        prefix = '' if shape == 'decode' else 'eval_shape_'
        stack_times.update({f'{prefix}chain_ms': chain_ms,
                            f'{prefix}graph_ms': graph_ms,
                            f'{prefix}round_ms': stack_round,
                            f'{prefix}chain_round_ms': chain_round})
    return flow_times, coupling_times, stack_times


def time_routes(inferencers, models, prior_1024, batch):
    """Decode at the 1024-frame bucket and the eval step under each route,
    through the kernels and through their plain versions, with a profiler
    window over the decodes for the device's idle share."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.ops.mas import maximum_path_reference
    b = prior_1024['durations'].shape[0]
    for route in ROUTES:
        model = inferencers[route].model
        gen = torch.Generator(device=batch['mels'].device)
        k_ms, p_ms = paired_ms(
            lambda: model.inference_decode(prior_1024, generator=gen,
                                           max_mel_length=1024),
            lambda: model.inference_decode(prior_1024, generator=gen,
                                           max_mel_length=1024,
                                           **plain_flow_fns()),
            iters=5, plain_iters=1, plain_warmup=1)
        print(f'decode phase under {route!r} B={b} bucket 1024: kernel '
              f'{k_ms:.3f} ms ({b * 1024 / k_ms * 1e3:.0f} mel frames/s of '
              f'capacity), plain {p_ms:.3f} ms '
              f'({b * 1024 / p_ms * 1e3:.0f} mel frames/s)')
        profile_window(
            f'decodes under {route!r}',
            lambda: model.inference_decode(prior_1024, generator=gen,
                                           max_mel_length=1024), 3)
        config = models[route].config
        eval_k = make_eval_step(config, models[route])
        eval_p = make_eval_step(config, models[route],
                                mas_fn=maximum_path_reference,
                                **plain_flow_fns())
        k_ms, p_ms = paired_ms(lambda: eval_k(batch), lambda: eval_p(batch),
                               iters=5, plain_iters=1, plain_warmup=1)
        print(f'eval step under {route!r} {tuple(batch["mels"].shape)}: '
              f'kernels {k_ms:.3f} ms, plain versions {p_ms:.2f} ms')


def mas_problem(device):
    """log_p [32, 224, 1024] with ragged lengths (tokens 10 … 200, frames
    50 … 1000), one sample with more tokens than frames and one of length
    1, masked to the lengths as the model masks it."""
    gen = torch.Generator().manual_seed(SEED + 4)
    b, t_tok, t_mel = EVAL_BATCH, EVAL_TOKENS, EVAL_FRAMES
    tl = torch.linspace(10, MAX_TOKENS, b).round().int()
    ml = torch.linspace(50, MAX_FRAMES, b).round().int()
    tl[3], ml[3] = MAX_TOKENS // 2, MAX_FRAMES // 14
    tl[1], ml[1] = 1, 1
    valid = ((torch.arange(t_tok)[None, :, None] < tl[:, None, None])
             & (torch.arange(t_mel)[None, None, :] < ml[:, None, None]))
    log_p = 3.0 * torch.randn((b, t_tok, t_mel), generator=gen) * valid
    return log_p.to(device), tl.to(device), ml.to(device)


def check_path(path, tl, ml):
    """Every sample with no more tokens than frames: one token per valid
    frame, none elsewhere, from token 0 to the last, never skipping."""
    t_mel = path.shape[2]
    frames = torch.arange(t_mel, device=path.device)[None, :]
    valid = frames < ml[:, None]
    fits = tl <= ml
    per_frame = path.sum(dim=1)                               # [B, T_mel]
    assert torch.equal(per_frame[fits], valid[fits].float()), 'frame cover'
    idx = path.argmax(dim=1)                                  # [B, T_mel]
    step = (idx[:, 1:] - idx[:, :-1]) * valid[:, 1:]
    assert ((step == 0) | (step == 1))[fits].all(), 'path not monotone'
    assert (idx[fits, 0] == 0).all()
    last = idx.gather(1, (ml.long() - 1).clamp_min(0)[:, None])[:, 0]
    assert torch.equal(last[fits], (tl.long() - 1)[fits]), 'path end'


def long_mas_problem(device):
    """log_p [2, 600, 2400]: frames far beyond the 1,303 the kernel took at
    1,024 tokens while its direction bits lived in shared memory."""
    gen = torch.Generator().manual_seed(SEED + 12)
    tl = torch.tensor([600, 450], dtype=torch.int32)
    ml = torch.tensor([2400, 2000], dtype=torch.int32)
    valid = ((torch.arange(600)[None, :, None] < tl[:, None, None])
             & (torch.arange(2400)[None, None, :] < ml[:, None, None]))
    log_p = 3.0 * torch.randn((2, 600, 2400), generator=gen) * valid
    return log_p.to(device), tl.to(device), ml.to(device)


def check_mas(device):
    """The MAS kernels against their plain version at the training shape
    and beyond the old frame limit: every element of the path equal, one
    counted launch (the library's two kernels) a call."""
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    worst = 0.0
    for log_p, tl, ml in (mas_problem(device), long_mas_problem(device)):
        launches, kernels = maximum_path.launches, maximum_path.kernels
        got = maximum_path(log_p, tl, ml)
        torch.cuda.synchronize()
        assert maximum_path.launches == launches + 1
        assert maximum_path.kernels == kernels + 2, 'recurrence, expansion'
        expected = maximum_path_reference(log_p, tl, ml)
        differing = (got != expected).sum().item()
        print(f'MAS kernels vs plain {tuple(log_p.shape)}, ragged lengths: '
              f'{differing} differing elements of {got.numel()}')
        assert differing == 0
        check_path(got, tl, ml)
        worst = max(worst, float((got - expected).abs().max().item()))
    return worst


def time_mas_phases(device, runs=5):
    """The MAS kernels' timed instantiation at the training shape, held to
    the plain path: the phases of the sample with the most frames in µs
    and warp 0's cycles a frame of the recurrence (medians of ``runs``)."""
    from glow_tts_tpu_torch.ops.mas import (maximum_path_reference,
                                            maximum_path_timed)
    log_p, tl, ml = mas_problem(device)
    expected = maximum_path_reference(log_p, tl, ml)
    splits = []
    for _ in range(runs):
        path, split = maximum_path_timed(log_p, tl, ml)
        assert torch.equal(path, expected), 'timed MAS differs from plain'
        splits.append(split)
    phases = {key: float(np.median([s['phases_ns'][key] for s in splits]))
              / 1e3 for key in splits[0]['phases_ns']}
    extra = {key: float(np.median([s[key] for s in splits]))
             for key in ('cycles_a_frame', 'last_warp_wait_cycles', 'sm_ghz')}
    print(f'MAS phases of the sample of {splits[0]["frames"]} frames '
          f'(median of {runs} timed runs): '
          + ', '.join(f'{key} {value:.2f} us' for key, value in phases.items())
          + f'; recurrence {extra["cycles_a_frame"]:.1f} cycles a frame '
          f'(warp 0) at {extra["sm_ghz"]:.2f} GHz, the last warp waited '
          f'{extra["last_warp_wait_cycles"]:.0f} cycles on its ring')
    return {'phases_us': phases, **extra}


def synthetic_items(config, seed):
    """A training batch's items: seeded texts of 10 … 200 tokens and seeded
    mels of 50 … 1000 frames, values in [−max_abs_mel, max_abs_mel]."""
    rng = np.random.default_rng(seed)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    items = []
    for n_tok, n_mel in zip(np.linspace(10, MAX_TOKENS, EVAL_BATCH).round(),
                            np.linspace(50, MAX_FRAMES, EVAL_BATCH).round()):
        chars = rng.choice(letters, int(n_tok) - 2)          # + <S>, <E>
        chars[5::6] = ' '
        a = config.sound.max_abs_mel
        mel = rng.uniform(-a, a, (int(n_mel), config.sound.mel_dim))
        items.append({'text': ''.join(chars), 'mel': mel.astype(np.float32)})
    order = rng.permutation(len(items))
    return [items[i] for i in order]


def fresh_model(state_dict, config, device):
    from glow_tts_tpu_torch import build_model
    from glow_tts_tpu_torch.weights import load_state_dict
    return load_state_dict(build_model(config), state_dict).to(device).prepare()


def check_ddi(model, batch, config):
    """ActNorm's data-dependent init through the kernel and through the
    plain flow step, on copies of one model; and the first step against
    the masked statistics of the squeezed batch computed directly."""
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    plain = copy.deepcopy(model)
    flow_step.launches = 0
    model.data_dependent_init(batch['mels'], batch['mel_lengths'])
    torch.cuda.synchronize()
    launches = flow_step.launches
    plain.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              step_fn=flow_step_reference)
    worst = 0.0
    steps = zip(model.layer_Dict['Decoder'].layer_Dict['Flows'],
                plain.layer_Dict['Decoder'].layer_Dict['Flows'])
    for k, (a, b) in enumerate(steps):
        for name in ('logs', 'bias'):
            got = getattr(a.layers[0], name)
            assert torch.isfinite(got).all(), (k, name)
            err = (got - getattr(b.layers[0], name)).abs().max().item()
            assert err <= DDI_ABS_BOUND, (k, name, err)
            worst = max(worst, err)
    mels = batch['mels']
    x, mask = squeeze(mels, sequence_mask(batch['mel_lengths'], mels.shape[1]),
                      config.decoder.num_squeeze)
    x, mask = x.double(), mask.double()
    n = mask.sum()
    mean = (x * mask).sum(dim=(0, 1)) / n
    std = ((x * x * mask).sum(dim=(0, 1)) / n - mean ** 2).sqrt()
    first = model.layer_Dict['Decoder'].layer_Dict['Flows'][0].layers[0]
    direct = max((first.logs.reshape(-1) + std.log()).abs().max().item(),
                 (first.bias.reshape(-1) + mean / std).abs().max().item())
    print(f'ActNorm data-dependent init, {launches} flow-step launches: '
          f'kernel vs plain max abs err {worst:.3e} over '
          f'{config.decoder.stack} steps; first '
          f'step vs direct statistics {direct:.3e}')
    assert launches == config.decoder.stack, launches
    assert direct <= DDI_ABS_BOUND, direct


def compare_eval(name, model, batch, config):
    """One batch through ``eval_step`` with the kernels and with their
    plain versions: losses, and the path where ``log_p`` is the same."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    seen = {}

    def recording(label, mas_fn):
        def mas(log_p, token_lengths, mel_lengths):
            seen[label] = (log_p, token_lengths, mel_lengths)
            return mas_fn(log_p, token_lengths, mel_lengths)
        return mas

    losses_k, out_k = make_eval_step(
        config, model, mas_fn=recording('kernel', maximum_path))(batch)
    losses_p, out_p = make_eval_step(
        config, model, mas_fn=recording('plain', maximum_path_reference),
        **plain_flow_fns())(batch)
    torch.cuda.synchronize()
    # the kernel's path on the eval path's own log_p, against the plain MAS
    log_p, tl, ml = seen['kernel']
    assert torch.equal(out_k['attentions'],
                       maximum_path_reference(log_p, tl, ml)), \
        f'{name}: MAS kernel differs from plain on the eval log_p'
    check_path(out_k['attentions'], tl, ml)
    same_log_p = torch.equal(log_p, seen['plain'][0])
    frames_off = int((out_k['attentions'] != out_p['attentions'])
                     .any(dim=1).sum().item())
    if same_log_p:
        assert frames_off == 0, f'{name}: same log_p, other path'
    line = (f'eval {name}: kernels mle {losses_k["mle"].item():.6f} '
            f'duration {losses_k["duration"].item():.6f}; plain mle '
            f'{losses_p["mle"].item():.6f} duration '
            f'{losses_p["duration"].item():.6f}; log_p bit-equal '
            f'{same_log_p}, max |dlog_p| '
            f'{(log_p - seen["plain"][0]).abs().max().item():.3e}, '
            f'{frames_off} frames aligned to another token')
    print(line)
    for key in ('mle', 'duration'):
        k, p = losses_k[key].item(), losses_p[key].item()
        assert np.isfinite(k) and np.isfinite(p), line
        assert abs(k - p) <= LOSS_REL_BOUND * abs(p), (key, line)
    return losses_k


def run_eval(model, batches, config, route='fused'):
    """The loss path: ``eval_step`` on each batch through the kernels of
    the ``coupling_backend`` route the model was built with."""
    from glow_tts_tpu_torch import attention_diagonality, make_eval_step
    eval_step = make_eval_step(config, model)
    zero_counts()
    results = [eval_step(batch) for batch in batches]
    launches = read_counts()
    for batch, (losses, outputs) in zip(batches, results):
        b, t_tok = batch['tokens'].shape
        t_mel = batch['mels'].shape[1]
        assert (t_tok, t_mel) == (EVAL_TOKENS, EVAL_FRAMES), (t_tok, t_mel)
        assert outputs['z'].shape == batch['mels'].shape
        assert outputs['attentions'].shape == (b, t_tok, t_mel)
        assert outputs['log_dets'].shape == (b,)
        for key, value in outputs.items():
            assert torch.isfinite(value).all(), key
        for key, value in losses.items():
            assert torch.isfinite(value), key
        assert torch.equal(outputs['attentions'].sum(dim=(1, 2)),
                           batch['mel_lengths'].float())
        diag = attention_diagonality(outputs['attentions'],
                                     batch['token_lengths'],
                                     batch['mel_lengths'])
        print(f'eval batch B={b} tokens {t_tok} frames {t_mel}: '
              f'mle {losses["mle"].item():.5f} duration '
              f'{losses["duration"].item():.5f} total '
              f'{losses["total"].item():.5f}, diagonality {diag.item():.4f}')
    expected = {**route_launches(route, config, len(batches)),
                'mas': len(batches)}
    print(f'evaluated {len(batches)} batches under {route!r}: launches '
          f'{launches} ({expected[ROUTES[route]]} {ROUTES[route]} and '
          f'{len(batches)} MAS expected, nothing else)')
    assert model.config.flow_route == route
    assert launches == expected, launches
    return launches


def time_eval(model, batch, config, device):
    """MAS kernel vs plain at the training shape, and the eval step's
    parts (the whole step is timed under each route by ``time_routes``)."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.models.glow_tts import prior_log_likelihood
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from glow_tts_tpu_torch.training.step import compute_losses
    log_p, tl, ml = mas_problem(device)
    k_ms, p_ms = paired_ms(lambda: maximum_path(log_p, tl, ml),
                           lambda: maximum_path_reference(log_p, tl, ml),
                           iters=20, plain_iters=1, plain_warmup=1)
    # what this run's lengths need: the valid part of log_p read once, the
    # whole path written once; per needed cell a max, an add and a compare
    cells = (tl.long() * ml.long()).sum().item()
    moved = 4 * (cells + log_p.numel() + 2 * tl.numel())
    bound_ms, bound_by = bound(moved, 3 * cells)
    print(f'MAS {tuple(log_p.shape)}: kernels {k_ms:.4f} ms, plain '
          f'{p_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} '
          f'({moved / 1e6:.1f} MB; the {int(ml.max())} dependent frames of '
          f'the longest sample hold the kernels, then the path\'s bytes)')
    mas_times = {'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': bound_ms,
                 'bound_by': bound_by, **time_mas_phases(device)}

    eval_k = make_eval_step(config, model)

    # the parts of one eval step, each alone, on this batch's tensors
    with torch.no_grad():
        tokens, mels = batch['tokens'], batch['mels']
        token_mask = sequence_mask(batch['token_lengths'], tokens.shape[1])
        mel_mask = sequence_mask(batch['mel_lengths'], mels.shape[1])
        encoder = model.layer_Dict['Encoder']
        decoder = model.layer_Dict['Decoder']
        mean, log_std, _ = encoder(tokens, token_mask)
        z, _, _ = decoder(mels, mel_mask)
        attn_mask = token_mask * mel_mask[:, None, :, 0]
        eval_log_p = prior_log_likelihood(mean, log_std, z, attn_mask)
        _, outputs = eval_k(batch)
        attn = outputs['attentions']

        def aligned():
            torch.einsum('bim,bij->bjm', mean, attn)
            torch.einsum('bim,bij->bjm', log_std, attn)

        parts = {
            'encoder': lambda: encoder(tokens, token_mask),
            f'forward flow ({config.decoder.stack} kernel launches)':
                lambda: decoder(mels, mel_mask),
            'log_p (two batched products)':
                lambda: prior_log_likelihood(mean, log_std, z, attn_mask),
            'MAS kernel on the eval log_p':
                lambda: maximum_path(eval_log_p, batch['token_lengths'],
                                     batch['mel_lengths']),
            'aligned statistics (two batched products)': aligned,
            'losses': lambda: compute_losses(config, outputs, batch),
        }
        for name, fn in parts.items():
            print(f'  eval part, {name}: {cuda_ms(fn, 5):.4f} ms')
    return mas_times, eval_k


def profile_window(label, fn, repeats, warmup=2, busy=False):
    """One ``torch.profiler`` window over ``repeats`` calls of ``fn``:
    device time by kernel, and the share of the window in which the device
    is idle (with ``busy``, also the device's busy ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    # kernels only: an operator's row repeats the time of the kernels it
    # launched
    by_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            total, count = by_name.get(event.name, (0.0, 0))
            by_name[event.name] = (total + event.time_range.elapsed_us() / 1e3,
                                   count + 1)
    rows = sorted(((ms, count, name) for name, (ms, count) in by_name.items()),
                  reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        print('profiler window: no device time recorded')
        return (None, None) if busy else None
    print(f'profiler window, {repeats} {label}: wall {wall_ms:.2f} ms, '
          f'{sum(count for _, count, _ in rows)} kernels busy {busy_ms:.2f} ms '
          f'(device idle {100 * (1 - busy_ms / wall_ms):.1f} % of the window)')
    for ms, count, key in rows[:10]:
        print(f'  {ms:9.3f} ms  {count:5d} x  {key[:90]}')
    if busy:
        return 1 - busy_ms / wall_ms, busy_ms / repeats
    return 1 - busy_ms / wall_ms


def train_model(state_dict, config, device):
    """A model as training holds it: weight norm unfolded."""
    from glow_tts_tpu_torch import build_model
    from glow_tts_tpu_torch.weights import load_state_dict
    model = load_state_dict(build_model(config), state_dict).to(device)
    return model.prepare(fold=False)


def rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def stack_problem(model, batch, config):
    """The flow stack's operands as a train step hands them over: the
    batch's squeezed mels and mask (ragged lengths), and the model's
    stacked weights, detached."""
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    mels = batch['mels']
    x, mask = squeeze(mels, sequence_mask(batch['mel_lengths'], mels.shape[1]),
                      config.decoder.num_squeeze)
    with torch.no_grad():
        weights = model.layer_Dict['Decoder'].pack_train()
    return x.contiguous(), mask, weights


def dropout_mask_errors(xd, mask, weights, seed, dtype=torch.float32):
    """#5's dropout masks of flow step S - 5 read element by element and
    held to ``dropmask.stack_mask``'s (the JAX package's, over the true
    2ch): with w_in = 0 and b_in = 1 the pre-gate sum is the keep factor,
    so a dropped element leaves tanh 0 and sigmoid 1/2 in the gate halves
    the backward's recompute saves; under a mask of ones every tile is
    live, so every element is drawn.  ``xd`` is the stack's input in the
    build's dtype.  Returns (the step, the differing elements, all of
    them, the share dropped)."""
    from glow_tts_tpu_torch.ops import coupling_grad, dropmask
    probe = dict(weights, w_in=torch.zeros_like(weights['w_in']),
                 b_in=torch.ones_like(weights['b_in']))
    s_steps, n, k, ch, ch2 = weights['w_in'].shape
    b, t, c = xd.shape
    step = s_steps - 5
    saved = coupling_grad._saved_buffers(b * t, c, ch, n, xd.device,
                                         dtype=dtype)
    coupling_grad._recompute(
        xd, torch.ones_like(mask), None,
        coupling_grad._kernel_weights(
            [probe[key] for key in coupling_grad.WEIGHT_KEYS], dtype),
        saved, step, coupling_grad._dropout_args(seed, FLOW_RATE))
    ts = saved['ts'].float()
    kept_kernel = torch.cat([ts[..., :ch] != 0, ts[..., ch:] != 0.5],
                            dim=-1).reshape(n, b, t, ch2)
    kept_plain = torch.stack([
        dropmask.stack_mask(seed, step, i, n, b, t, k, ch2, FLOW_RATE,
                            xd.device) != 0 for i in range(n)])
    return (step, (kept_kernel != kept_plain).sum().item(),
            kept_plain.numel(), 1.0 - kept_plain.float().mean().item())


def check_train_forward(x, mask, weights):
    """Kernel #5 against the plain version, the whole stack, at dropout
    rate 0.05 and 0 with the same (negative) seed; and the kernel's masks
    read element by element through a probe stack whose pre-gate sum is the
    keep factor itself."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    seed, worst = -20240229, 0.0
    with torch.no_grad():
        for rate in (FLOW_RATE, 0.0):
            z_k, ld_k = flow_stack_train(x, mask, weights, seed=seed,
                                         dropout_rate=rate)
            z_p, ld_p = flow_stack_train_reference(x, mask, weights,
                                                   seed=seed,
                                                   dropout_rate=rate)
            torch.cuda.synchronize()
            z_rel, ld_rel = rel_err(z_k, z_p), rel_err(ld_k, ld_p)
            line = (f'train forward kernel vs plain {tuple(x.shape)}, '
                    f'{weights["w_in"].shape[0]} steps, rate {rate}: z max '
                    f'abs err {(z_k - z_p).abs().max().item():.3e}, rel '
                    f'{z_rel:.3e}; logdet rel {ld_rel:.3e}')
            print(line)
            assert torch.isfinite(z_k).all() and torch.isfinite(ld_k).all()
            assert z_rel < TRAIN_Z_REL_BOUND, line
            assert ld_rel < TRAIN_LD_REL_BOUND, line
            worst = max(worst, (z_k - z_p).abs().max().item())
            if rate:
                z_1, _ = coupling_grad._apply_kernels(
                    x, mask, weights, None, seed, rate, forward_passes=1)
                one_pass = rel_err(z_1, z_p)
                line = (f'train forward precision, rate {rate}: 3xTF32 '
                        f'shipped, z max rel err {z_rel:.3e}; 1xTF32 '
                        f'{one_pass:.3e} (bar {TRAIN_Z_REL_BOUND:.0e})')
                print(line)
                assert one_pass > ONE_PASS_MARGIN * z_rel, line

        step, differing, elements, dropped = dropout_mask_errors(
            x, mask, weights, seed)
        print(f'dropout masks of flow step {step}, kernel vs plain: '
              f'{differing} differing elements of {elements} '
              f'({100 * dropped:.3f} % dropped at rate {FLOW_RATE})')
        assert differing == 0
        assert abs(dropped - FLOW_RATE) < 2e-3
    return worst, one_pass


def forced_route(route, passes=None):
    """``flow_stack_train``'s kernels with the forward pass's route
    (``'store'`` or ``'recompute'``) and, unless None (the wrapper's
    default for the dtype), the backward GEMMs' TF32 passes forced,
    through the wrapper's private entry."""
    from glow_tts_tpu_torch.ops import coupling_grad

    def fn(x, mask, weights, cond=None, pitch=None, *, seed, dropout_rate):
        return coupling_grad._apply_kernels(x, mask, weights, cond, seed,
                                            dropout_rate, route, passes,
                                            pitch=pitch)
    return fn


def check_train_backward(x, mask, weights, cond=None, pitch=None):
    """Kernel #6 against autograd of the plain version: dx and every
    weight gradient of a loss through z and the logdet (and dcond, and
    with a pitch operand, which takes #5's and #6's pitch builds, dpitch),
    under both routes (activations stored by the forward pass, and
    recomputed step by step); the two routes bit-equal, and two runs of
    each; the last layer's residual-half gradient exactly zero; the error
    of one TF32 pass beside that of the shipped product; with a pitch
    operand that wants no gradient, dpitch skipped and every other
    gradient the same bits."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    gen = torch.Generator().manual_seed(SEED + 5)
    dz = torch.randn(x.shape, generator=gen).to(x.device)
    dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(x.device)

    def gradients(fn, pitch_grad=True):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = x.clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_(
            pitch_grad)
        z, ld = fn(xl, mask, leaves, cl, pl, seed=SEED + 6,
                   dropout_rate=FLOW_RATE)
        (torch.sum(z * dz) + torch.sum(ld * dld)).backward()
        torch.cuda.synchronize()
        out = {'x': xl.grad, **{key: leaf.grad
                                for key, leaf in leaves.items()}}
        for key, leaf in (('cond', cl), ('pitch', pl)):
            if leaf is not None and leaf.requires_grad:
                out[key] = leaf.grad
        return out

    s_steps, n, _, ch, _ = weights['w_in'].shape
    b, t, c = x.shape
    chosen = ('store' if coupling_grad.stores_activations(
        s_steps, b * t, c, ch, n) else 'recompute')
    build = build_suffix(channels=x.shape[-1], pitch=pitch is not None)
    per_step = (BWD_KERNELS_PER_FLOW_STEP if pitch is None
                else BWD_PITCH_KERNELS_PER_FLOW_STEP)
    zero_counts()
    got = gradients(flow_stack_train)
    counts = read_counts()
    expected = {**no_launches(), f'train_fwd{build}': s_steps,
                f'train_recompute{build}': (0 if chosen == 'store'
                                            else s_steps),
                f'train_bwd{build}': per_step * s_steps}
    assert counts == expected, counts
    runs = {route: [gradients(forced_route(route)) for _ in range(2)]
            for route in ('store', 'recompute')}
    ref = gradients(flow_stack_train_reference)
    one_pass = gradients(forced_route(chosen, passes=1))
    if pitch is not None:
        without = gradients(flow_stack_train, pitch_grad=False)
        assert set(without) == set(got) - {'pitch'}, set(without)
        for key, value in without.items():
            assert torch.equal(value, got[key]), \
                f'd{key} differs when dpitch is skipped'
    worst_abs, worst_rel, worst_one, lines = 0.0, 0.0, 0.0, []
    for key, value in ref.items():
        assert torch.isfinite(got[key]).all(), key
        for route, (first, second) in runs.items():
            assert torch.equal(first[key], second[key]), \
                f'd{key} differs by run under {route!r}'
            assert torch.equal(first[key], got[key]), \
                f'd{key} under {route!r} differs from the {chosen!r} route'
        rel = rel_err(got[key], value)
        lines.append(f'd{key} {rel:.2e}')
        assert rel < GRAD_REL_BOUND, (key, rel)
        worst_rel = max(worst_rel, rel)
        worst_one = max(worst_one, rel_err(one_pass[key], value))
        worst_abs = max(worst_abs, (got[key] - value).abs().max().item())
    assert (got['w_rs'][:, -1, :, :ch] == 0).all(), 'dead res half of dw_rs'
    assert (got['b_rs'][:, -1, :ch] == 0).all(), 'dead res half of db_rs'
    what = (f'kernel ({x.shape[-1]}-channel build)' if pitch is None
            else 'pitch build, cond and pitch, dpitch skipped when not '
                 'wanted with the other gradients bit-equal;')
    print(f'train backward {what} vs autograd of plain {tuple(x.shape)}, '
          f'rate {FLOW_RATE}: worst gradient rel err {worst_rel:.3e} of '
          f'its tensor\'s max-abs (bar {GRAD_REL_BOUND:.0e}); route '
          f'{chosen!r} by the shapes, {per_step} launches '
          f'of the backward library per flow step; stored and recomputed '
          f'routes bit-equal, two runs of each bit-equal; last layer\'s '
          f'residual-half gradient exactly 0')
    print('  ' + ', '.join(lines))
    print(f'backward GEMM precision: {coupling_grad.TF32_PASSES}xTF32 '
          f'shipped, worst gradient rel err {worst_rel:.3e}; 1xTF32 '
          f'{worst_one:.3e} (bar {GRAD_REL_BOUND:.0e})')
    return worst_abs


def train_path_launches(config, steps):
    """The launches of the train path in ``config``'s mode: ActNorm's init
    (one flow-step launch per flow step), then ``steps`` train steps (a
    forward launch per flow step, which stores at the training shape, the
    backward's kernels and one MAS each); GR mode's through the pitch
    builds."""
    flows = config.decoder.stack
    gr = config.uses_gradient_reversal
    build = build_suffix(config, pitch=gr)
    bwd = BWD_PITCH_KERNELS_PER_FLOW_STEP if gr else BWD_KERNELS_PER_FLOW_STEP
    return {**no_launches(), f'flow_step{build}': flows,
            'mas': steps, f'train_fwd{build}': flows * steps,
            f'train_bwd{build}': bwd * flows * steps}


def run_training(config, batch, device, steps=TRAIN_STEPS, plain=True,
                 state=None):
    """The train path: ActNorm's data-dependent init, then ``steps`` train
    steps, through the kernels and, with ``plain``, from the same initial
    weights, seed and generator state, through the plain versions, held
    together step by step; the batch's conditioning in the conditioned
    modes.  From-scratch weights unless ``state`` is given."""
    from glow_tts_tpu_torch import (initial_state_dict, make_eval_step,
                                    make_optimizer, make_train_step)
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    state = state if state is not None else initial_state_dict(config, SEED)
    mode = config.mode if config.mode != 'SE' else (
        'SE-GE2E' if config.uses_ge2e else 'SE-LUT')
    runs = {}
    for name, step_fn, stack_fn, mas_fn in (
            ('kernels', flow_step, flow_stack_train, maximum_path),
            ('plain', flow_step_reference, flow_stack_train_reference,
             maximum_path_reference))[:2 if plain else 1]:
        model = train_model(state, config, device)
        eval_step = make_eval_step(config, model, step_fn=step_fn,
                                   mas_fn=mas_fn)
        train_step = make_train_step(
            config, model, make_optimizer(config, model.parameters()),
            seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED),
            stack_fn=stack_fn, mas_fn=mas_fn)
        # the path is the init and the steps; the eval between them (the
        # loss before the steps) is not of the path and is not counted
        zero_counts()
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  step_fn=step_fn,
                                  **conditioning_inputs(batch))
        init_counts = read_counts()
        before = eval_step(batch)[0]['total'].item()
        zero_counts()
        metrics = [train_step(batch) for _ in range(steps)]
        step_counts = read_counts()
        if name == 'kernels':
            launches = {key: init_counts[key] + step_counts[key]
                        for key in step_counts}
        after = eval_step(batch)[0]['total'].item()
        runs[name] = ([{key: value.item() for key, value in m.items()}
                       for m in metrics], before, after)

    flows = config.decoder.stack
    bwd = (BWD_PITCH_KERNELS_PER_FLOW_STEP if config.uses_gradient_reversal
           else BWD_KERNELS_PER_FLOW_STEP)
    label = 'train path' if mode == 'Vanilla' else f'{mode} train path'
    print(f'{label}, {steps} steps after the data-dependent init: '
          f'launches {launches} ({flows} forward, no recompute (the forward '
          f'stores), {flows} x {bwd} backward kernels '
          f'and 1 MAS expected per step, {flows} flow steps for the init)')
    assert launches == train_path_launches(config, steps), launches
    keys = ['total', 'mle', 'duration'] + (
        ['speaker'] if config.uses_gradient_reversal else [])
    if not plain:
        for i, k in enumerate(runs['kernels'][0]):
            print(f'  step {i}: kernels ' + ' '.join(
                f'{key} {k[key]:.6f}' for key in keys)
                + f' grad_norm {k["grad_norm"]:.5f}')
            assert all(np.isfinite(value) for value in k.values()), (i, k)
        return launches
    for i, (k, p) in enumerate(zip(runs['kernels'][0], runs['plain'][0])):
        print(f'  step {i}: kernels ' + ' '.join(
            f'{key} {k[key]:.6f}' for key in keys)
            + f' grad_norm {k["grad_norm"]:.5f}; plain ' + ' '.join(
            f'{key} {p[key]:.6f}' for key in keys)
            + f' grad_norm {p["grad_norm"]:.5f}')
        for key in keys + ['grad_norm']:
            bar = (TRAIN_NORM_REL_BOUND if key == 'grad_norm'
                   else TRAIN_LOSS_REL_BOUND)
            assert np.isfinite(k[key]) and np.isfinite(p[key]), (i, key)
            assert abs(k[key] - p[key]) <= bar * abs(p[key]), (i, key, k, p)
    for name, (_, before, after) in runs.items():
        print(f'  eval total on the batch before and after the steps, '
              f'{name}: {before:.6f} -> {after:.6f}')
        assert np.isfinite(after) and after < before, (name, before, after)
    return launches


def time_backward_gemms(device):
    """The backward library's two GEMMs alone, one launch each (the weight
    gradient's with its reduction), at the dominant shapes of a flow step
    with all 32 x 512 frames valid, with 3 and with 1 TF32 passes; and, as
    yardsticks the port never calls, ``torch.matmul`` on the same products
    in f32 and with TF32 allowed."""
    from glow_tts_tpu_torch.ops import coupling_grad
    gen = torch.Generator().manual_seed(SEED + 12)
    b, t, ch, k = 32, 512, 192, 5
    mask = torch.ones((b, t, 1), device=device)
    dpre = torch.randn((b, t, 2 * ch), generator=gen).to(device)
    xin = torch.randn((b, t, ch), generator=gen).to(device)
    w_in = (torch.randn((k, ch, 2 * ch), generator=gen) * .03).to(device)
    # the same products as plain matrices: im2col of the shifted rows
    pad = (k - 1) // 2

    def shifted(rows, shifts):
        padded = torch.nn.functional.pad(rows, (0, 0, pad, pad))
        return torch.cat([padded[:, pad + s: pad + s + t] for s in shifts],
                         dim=-1).reshape(b * t, -1)

    dgrad_a = shifted(dpre, [pad - tap for tap in range(k)])   # [M, k*2ch]
    dgrad_b = w_in.permute(0, 2, 1).reshape(k * 2 * ch, ch)    # [k*2ch, ch]
    wgrad_a = shifted(xin, [tap - pad for tap in range(k)]).T  # [k*ch, M]
    wgrad_b = dpre.reshape(b * t, 2 * ch)                      # [M, 2ch]
    flops = 2 * b * t * k * ch * 2 * ch
    products = {
        'gemm_nt, in-conv dgrad (16384 x 1920 . 1920 x 192)': (
            lambda passes: coupling_grad._dgrad_product(dpre, w_in, mask,
                                                        passes),
            lambda: (dgrad_a @ dgrad_b).reshape(b, t, ch)),
        'gemm_tn + reduction, dw_in (960 x 16384 . 16384 x 384)': (
            lambda passes: coupling_grad._wgrad_product(xin, dpre, mask, k,
                                                        passes),
            lambda: wgrad_a @ wgrad_b)}
    for name, (kernel_fn, matmul_fn) in products.items():
        exact = matmul_fn()
        errs = {passes: rel_err(kernel_fn(passes), exact) for passes in (3, 1)}
        assert errs[3] < GRAD_REL_BOUND, (name, errs)
        runs = [(passes, cuda_ms(lambda: kernel_fn(passes), 20))
                for passes in (3, 1, 1, 3)]
        ms = {passes: sum(t for p, t in runs if p == passes) / 2
              for passes in (3, 1)}
        f32_ms = cuda_ms(matmul_fn, 20)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_ms = cuda_ms(matmul_fn, 20)
        tf32_err = rel_err(matmul_fn(), exact)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f'{name}, {flops / 1e9:.1f} GFLOP: 3xTF32 {ms[3]:.4f} ms '
              f'({flops / ms[3] / 1e9:.1f} TFLOP/s, rel err {errs[3]:.2e} of '
              f'torch.matmul f32), 1xTF32 {ms[1]:.4f} ms (rel err '
              f'{errs[1]:.2e}); yardsticks torch.matmul f32 {f32_ms:.4f} ms '
              f'({flops / f32_ms / 1e9:.1f} TFLOP/s), with TF32 allowed '
              f'{tf32_ms:.4f} ms (rel err {tf32_err:.2e})')


def time_training(config, batch, x, mask, weights, device, extras=True):
    """Kernels #5 and #6 and their plain version alone, with the bounds of
    #5 and #6 from this run's shapes; with ``extras``, also the train step
    with kernels and with plain versions, its parts each alone, a profiler
    window over train steps, #6 under the recompute route and at one TF32
    pass, and the backward's two GEMMs alone at the shipped width."""
    from glow_tts_tpu_torch import (make_optimizer, make_train_step,
                                    random_state_dict)
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path_reference
    state = random_state_dict(config, SEED) if extras else None

    def stepper(stack_fn=None, mas_fn=None):
        model = train_model(state, config, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'])
        kwargs = {key: value for key, value in (
            ('stack_fn', stack_fn), ('mas_fn', mas_fn)) if value is not None}
        optimizer = make_optimizer(config, model.parameters())
        step = make_train_step(
            config, model, optimizer, seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED),
            **kwargs)
        return model, optimizer, step

    if extras:
        model, optimizer, step_k = stepper()
        _, _, step_p = stepper(flow_stack_train_reference,
                               maximum_path_reference)
        k_ms, p_ms = paired_ms(lambda: step_k(batch), lambda: step_p(batch),
                               iters=2, plain_iters=1, plain_warmup=1)
        shape = tuple(batch['mels'].shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step_k(batch)
        torch.cuda.synchronize()
        print(f'train step {shape}: kernels {k_ms:.3f} ms, plain versions '
              f'{p_ms:.2f} ms; peak memory of a step with kernels '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB '
              f'({held / 2 ** 30:.3f} held before)')

    # the flow alone, forward and backward: the kernels under both routes
    # and with one TF32 pass, and the plain version
    gen = torch.Generator().manual_seed(SEED + 7)
    dz = torch.randn(x.shape, generator=gen).to(device)
    dld = torch.ones(x.shape[0], device=device)

    times, peaks = {}, {}
    for name, fn, iters in (
            ('kernel', flow_stack_train, 3),
            *((('kernel, recompute route', forced_route('recompute'), 3),
               ('kernel, stored, 1xTF32', forced_route('store', passes=1), 3))
              if extras else ()),
            ('plain', flow_stack_train_reference, 2)):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = x.clone().requires_grad_()
        inputs = [xl, *leaves.values()]

        def forward():
            return fn(xl, mask, leaves, seed=SEED, dropout_rate=FLOW_RATE)

        with torch.no_grad():
            plain_fwd_ms = cuda_ms(forward, iters, 1)
        fwd_ms = cuda_ms(forward, iters, 1)       # as a train step runs it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        z, ld = forward()
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            (z, ld), inputs, (dz, dld), retain_graph=True), iters, 1)
        peaks[name] = (held, torch.cuda.max_memory_allocated())
        times[name] = (fwd_ms, bwd_ms, plain_fwd_ms)
        del z, ld
    s_steps, n_layers, _, ch, _ = weights['w_in'].shape
    per_step = {key: value[0] for key, value in weights.items()}
    frame_flops = step_frame_flops(per_step)
    flops = frame_flops * mask.sum().item()
    weight_count = sum(value.numel() for value in per_step.values())
    fwd_bounds = body_bounds(4 * (2 * x.numel() + mask.numel() + x.shape[0]
                                  + weight_count), flops)
    # the backward's work is dgrad + wgrad on the valid frames, each the
    # forward's operations, on the tensor cores (counted once, whatever the
    # number of TF32 passes); it reads the step's input, its saved
    # activations, the cotangent and the weights and writes the cotangent
    # and the gradients, each once
    saved_bytes = coupling_grad.saved_bytes_per_step(
        x.shape[0] * x.shape[1], x.shape[2], ch, n_layers)
    bwd_bytes = saved_bytes + 4 * (3 * x.numel() + mask.numel() + x.shape[0]
                                   + 2 * weight_count)
    bwd_bound = bound(bwd_bytes, 2 * flops, PEAK_TF32_FLOP_PER_S)
    fma_bound = bound(bwd_bytes, 2 * flops)
    for label, (fwd_ms, bwd_ms, plain_fwd_ms) in times.items():
        held, peak = peaks[label]
        print(f'flow stack {tuple(x.shape)}, {s_steps} steps, rate '
              f'{FLOW_RATE}, {label}: forward {fwd_ms:.3f} ms '
              f'({fwd_ms / s_steps:.4f} per step; {plain_fwd_ms:.3f} ms '
              f'under no_grad), backward {bwd_ms:.3f} ms '
              f'({bwd_ms / s_steps:.4f} per step); peak memory of forward + '
              f'backward {peak / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f} held '
              f'before)')
    k_fwd, k_bwd, _ = (value / s_steps for value in times['kernel'])
    with torch.no_grad():           # the storing instantiation, as a step's
        tiles = live_tiles(mask, lambda report: coupling_grad._apply_kernels(
            x, mask, weights, None, SEED, FLOW_RATE, route='store',
            tiles=report), steps=s_steps)
    print(f'  per flow step: {int(mask.sum().item())} valid frames; '
          f'forward {flops / k_fwd / 1e9:.2f} TFLOP/s on '
          f'{tiles["computed"] // s_steps} of {tiles["items"]} tiles '
          f'({tiles["rounds"]} rounds on {tiles["blocks"]} blocks, as the '
          f'kernel reports them), bound {fwd_bounds["bound_ms"]:.4f} ms by '
          f'{fwd_bounds["bound_by"]} at the TF32 peak '
          f'({fwd_bounds["fma_bound_ms"]:.4f} ms at the f32 FMA peak); '
          f'backward '
          f'{2 * flops / k_bwd / 1e9:.2f} TFLOP/s over dgrad and wgrad '
          f'({2 * flops / 1e9:.1f} GFLOP, {bwd_bytes / 1e6:.0f} MB), bound '
          f'{bwd_bound[0]:.4f} ms by {bwd_bound[1]} at the TF32 peak '
          f'({fma_bound[0]:.4f} ms at the f32 FMA peak)')
    if not extras:
        return ({'ms': k_fwd, 'plain_ms': times['plain'][0] / s_steps,
                 **fwd_bounds,
                 'schedule': {'live_tiles': tiles['computed'] // s_steps,
                              'tiles': tiles['items'],
                              'rounds': tiles['rounds'],
                              'blocks': tiles['blocks']}},
                {'ms': k_bwd, 'plain_ms': times['plain'][1] / s_steps,
                 'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1]})
    time_backward_gemms(device)

    # the other parts of a train step, each alone
    tokens = batch['tokens']
    token_mask = sequence_mask(batch['token_lengths'], tokens.shape[1])
    encoder = model.layer_Dict['Encoder']
    decoder = model.layer_Dict['Decoder']
    enc_gen = torch.Generator(device=device).manual_seed(SEED)

    def encoder_both():
        outs = encoder(tokens, token_mask, None, False, enc_gen)
        sum(out.sum() for out in outs).backward()

    def pack_both():
        packed = decoder.pack_train()
        sum(value.sum() for value in packed.values()).backward()

    parts = {'encoder forward + backward': encoder_both,
             'weight pack forward + backward': pack_both,
             'optimiser update': optimizer.step}
    profile_window('train steps', lambda: step_k(batch), 3, warmup=1)
    for name, fn in parts.items():
        print(f'  train part, {name}: {cuda_ms(fn, 5):.4f} ms')
    return ({'ms': k_fwd, 'plain_ms': times['plain'][0] / s_steps,
             **fwd_bounds,
             'schedule': {'live_tiles': tiles['computed'] // s_steps,
                          'tiles': tiles['items'],
                          'rounds': tiles['rounds'],
                          'blocks': tiles['blocks']}},
            {'ms': k_bwd, 'plain_ms': times['plain'][1] / s_steps,
             'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1],
             'recompute_route_ms':
                 times['kernel, recompute route'][1] / s_steps,
             'one_pass_ms': times['kernel, stored, 1xTF32'][1] / s_steps})


def write_archive(path, n, config, seed, conditioned=False):
    """``n`` patterns with the port's pattern IO, as ``synthetic_items``
    makes a batch's items: texts of 10 … 200 characters, mels of 50 … 1000
    frames uniform in [−max_abs_mel, max_abs_mel]; ``conditioned``, with
    seeded speaker ids (of the config's speakers) and pitch tracks, else
    speaker 0 and zero pitch."""
    from glow_tts_tpu_torch.data.patterns import (build_metadata,
                                                  save_metadata, save_pattern)
    rng = np.random.default_rng(seed)
    extra = np.random.default_rng(seed + 1000)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    a = config.sound.max_abs_mel
    for i, (n_text, n_mel) in enumerate(zip(
            rng.permutation(np.linspace(10, MAX_TOKENS, n).round()),
            rng.permutation(np.linspace(50, MAX_FRAMES, n).round()))):
        chars = rng.choice(letters, int(n_text))
        chars[5::6] = ' '
        mel = rng.uniform(-a, a, (int(n_mel), config.sound.mel_dim))
        speaker, pitch = 0, np.zeros(int(n_mel), np.float32)
        if conditioned:
            speaker = int(extra.integers(
                config.speaker_embedding.num_speakers))
            pitch = extra.random(int(n_mel)).astype(np.float32)
        save_pattern(os.path.join(path, f'P{i:03d}.PICKLE'), {
            'Audio': np.zeros(int(n_mel), np.float32),
            'Mel': mel.astype(np.float32), 'Pitch': pitch,
            'Speaker_ID': speaker, 'Speaker': 'Synthetic',
            'Dataset': 'Synthetic', 'Text': ''.join(chars)})
    save_metadata(path, build_metadata(path, config.sound))


class PartCounts:
    """Launch counts of the trainer's path by part: a wrapped call runs
    with every count set to 0 just before it and read just after, and the
    part sums what its calls read."""

    def __init__(self):
        self.by_part = {}

    def add(self, part, counts):
        total = self.by_part.setdefault(part, no_launches())
        for key, value in counts.items():
            total[key] += value

    def wrap(self, part, fn):
        def counted(*args, **kwargs):
            zero_counts()
            out = fn(*args, **kwargs)
            self.add(part, read_counts())
            return out
        counted.uncounted = fn
        return counted

    @staticmethod
    def unwrap(trainer):
        """The trainer's own methods back: a counted call synchronises."""
        trainer.train_step = trainer.train_step.uncounted
        trainer.eval_step = trainer.eval_step.uncounted
        del trainer.model.inference_decode, trainer.run_inference_file


def trainer_config(config, root, run, max_step, inference=True):
    """``config`` training on the archives under ``root``, its outputs
    under ``root/run``; with ``inference``, the TSV ``sentences.tsv`` is
    served at the inference interval."""
    from glow_tts_tpu_torch.config import PatternConfig
    train = dataclasses.replace(
        config.train, max_step=max_step, checkpoint_save_interval=SAVE_EVERY,
        logging_interval=SAVE_EVERY, evaluation_interval=EVAL_EVERY,
        inference_interval=EVAL_EVERY,
        train_pattern=PatternConfig(path=os.path.join(root, 'train')),
        eval_pattern=PatternConfig(path=os.path.join(root, 'eval')),
        inference_pattern_file_in_train=(
            os.path.join(root, 'sentences.tsv') if inference else None))
    return dataclasses.replace(
        config, train=train,
        checkpoint_path=os.path.join(root, run, 'checkpoint'),
        log_path=os.path.join(root, run, 'log'),
        inference_path=os.path.join(root, run, 'inference'))


def new_trainer(config, root, run, max_step, device, counts=None,
                inference=True):
    """A ``Trainer`` with a recording writer pair; with ``counts``, its
    construction (ActNorm's init), train steps, eval steps, free-running
    decodes and inference runs counted by part."""
    from glow_tts_tpu_torch import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    make = lambda: Trainer(  # noqa: E731
        trainer_config(config, root, run, max_step, inference),
        device=device,
        writers={'train': MemoryWriter(), 'eval': MemoryWriter()})
    if counts is None:
        return make()
    trainer = counts.wrap('trainer init', make)()
    trainer.train_step = counts.wrap('trainer train', trainer.train_step)
    trainer.eval_step = counts.wrap('trainer eval', trainer.eval_step)
    trainer.model.inference_decode = counts.wrap(
        'trainer decode', trainer.model.inference_decode)
    trainer.run_inference_file = counts.wrap(
        'trainer inference', trainer.run_inference_file)
    return trainer


def compare_runs(a, b, resume_step=RESUME_STEP):
    """B against A by group (the final parameters, each optimiser moment,
    the logged train and eval losses after the restore at
    ``resume_step``, and the 'em' warmup's statistics where the runs have
    them): the largest
    difference over the group relative to the group's max-abs, and the
    tensor that holds it; and whether every tensor is bit-equal.  (A
    tensor's own max-abs is no scale where its gradient is rounding noise,
    as the attention's key bias's is: a bias that moves every score of a
    query alike has no gradient through the softmax.)"""
    sa, sb = a.optimizer.state_dict(a.model), b.optimizer.state_dict(b.model)
    assert sa['count'] == sb['count'] == TRAINER_STEPS, (sa['count'],
                                                         sb['count'])
    groups = {
        'parameters': [(name, value, dict(b.model.named_parameters())[name])
                       for name, value in a.model.named_parameters()],
        **{key: [(name, value, sb[key][name])
                 for name, value in sa[key].items()] for key in ('mu', 'nu')}}
    for kind in ('train', 'eval'):
        logged = b.writers[kind].scalars
        groups[f'{kind} losses'] = [
            (tag, torch.tensor([v for step, v in values
                                if step > resume_step]),
             torch.tensor([v for step, v in logged[tag]
                           if step > resume_step]))
            for tag, values in a.writers[kind].scalars.items()
            if tag.startswith('Loss/')
            and any(step > resume_step for step, _ in values)]
    if a.em.stats is not None:
        groups['em_stats'] = list(zip(('cnt', 's0', 's1'), a.em.stats,
                                      b.em.stats))
    errs, equal = {}, True
    for group, pairs in groups.items():
        assert pairs and all(want.shape == got.shape and want.numel()
                             for _, want, got in pairs), group
        scale = max(want.abs().max().item() for _, want, _ in pairs)
        diffs = {name: (got - want).abs().max().item()
                 for name, want, got in pairs}
        worst = max(diffs, key=diffs.get)
        errs[group] = (diffs[worst] / max(scale, 1e-30), worst)
        equal &= all(torch.equal(want, got) for _, want, got in pairs)
    return errs, equal


def time_fed_loop(trainer, root, config, device, card):
    """Steps/s of the data-fed loop (the trainer's loader, the copy and
    ``train_step``; no checkpoint, log or evaluation) against the same
    batches assembled beforehand and copied each step, and already on the
    card, in alternating runs; each copy of the largest batch alone, and
    one batch's host assembly alone.  The loader runs over an archive of
    ``TIMING_BATCHES`` batches an epoch, so that a run (a warm-up step and
    ``FED_STEPS``) stays inside one epoch: every run takes the same
    batches, and no new loader waits for its first batch inside a timed
    window."""
    from glow_tts_tpu_torch import batch_to_device
    from glow_tts_tpu_torch.config import PatternConfig
    from glow_tts_tpu_torch.training.trainer import pattern_dataset

    path = os.path.join(root, 'timing')
    write_archive(path, TIMING_BATCHES * config.train.batch_size, config,
                  SEED + 22)
    trainer.train_dataset = pattern_dataset(PatternConfig(path=path),
                                            use_cache=False)
    assert len(trainer.train_loader(0)) == TIMING_BATCHES

    def run(batches, copy):
        """ms a step over ``FED_STEPS`` after a warm-up, synchronised at
        the end; the host's wait for the next batch; the batches."""
        start = time.perf_counter()
        batch = next(batches)
        first_ms = (time.perf_counter() - start) * 1e3
        seen = [batch]
        trainer.train_step(copy(batch))                        # warm-up
        torch.cuda.synchronize()
        wait = 0.0
        start = time.perf_counter()
        for _ in range(FED_STEPS):
            before = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - before
            seen.append(batch)
            trainer.train_step(copy(batch))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        return elapsed * 1e3 / FED_STEPS, wait * 1e3 / FED_STEPS, \
            first_ms, seen

    def fed():
        batches = iter(trainer.train_loader(0))
        try:
            return run(batches, lambda b: batch_to_device(b, device))
        finally:
            batches.close()

    ms, wait, first, seen = fed()
    runs = {'fed': [ms], 'copied': [], 'bare': []}
    waits, firsts = [wait], [first]
    resident = [batch_to_device(batch, device) for batch in seen]
    order = ['fed', 'copied', 'bare']
    for name in order[1:] + order[::-1] + order:
        if name == 'fed':
            ms, wait, first, again = fed()
            assert all(np.array_equal(x['mel_lengths'], y['mel_lengths'])
                       for x, y in zip(seen, again)), 'the epoch moved'
            waits.append(wait)
            firsts.append(first)
        elif name == 'copied':
            ms = run(iter(seen), lambda b: batch_to_device(b, device))[0]
        else:
            ms = run(iter(resident), lambda b: b)[0]
        runs[name].append(ms)
    means = {name: float(np.mean(values)) for name, values in runs.items()}
    wait_ms = float(np.mean(waits))

    largest = max(seen, key=lambda batch: batch['mels'].size)
    copies = {'pinned, non_blocking (batch_to_device)':
                  lambda batch: batch_to_device(batch, device),
              'pageable, torch.as_tensor':
                  lambda batch: {key: torch.as_tensor(value, device=device)
                                 for key, value in batch.items()}}

    def copy_ms(copy):
        copy(largest)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(COPY_ITERS):
            copy(largest)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / COPY_ITERS

    # one batch's host assembly alone, on this thread: the pickles read
    # and collated, as a producer thread does it
    sampler = trainer.train_loader(0).sampler
    start = time.perf_counter()
    assembled = [trainer.collater([trainer.train_dataset[int(i)]
                                   for i in indices]) for indices in sampler]
    assembly_ms = (time.perf_counter() - start) * 1e3 / len(assembled)

    names = list(copies)
    copy_runs = {name: [] for name in names}
    for name in names + names[::-1] + names:
        copy_runs[name].append(copy_ms(copies[name]))
    copy_times = {name: float(np.mean(values))
                  for name, values in copy_runs.items()}
    shapes = [batch['mels'].shape[1] for batch in seen]
    megabytes = sum(v.nbytes for v in largest.values()) / 1e6
    fed_ms, copied_ms, bare_ms = means['fed'], means['copied'], means['bare']

    def listed(values, digits=3):
        return ', '.join(f'{v:.{digits}f}' for v in values)
    print(f'trainer, data-fed loop: {FED_STEPS} steps after a warm-up, '
          f'inside one epoch of {TIMING_BATCHES} batches (frames of the '
          f'run\'s batches {shapes}), {len(runs["fed"])} runs each in the '
          f'order {", ".join(order[:1] + order[1:] + order[::-1] + order)}; '
          f'{card}')
    print(f'  fed (the trainer\'s loader, {trainer.config.train.num_workers}'
          f' producer threads, the pinned copy, the step): {fed_ms:.3f} ms '
          f'a step = {1e3 / fed_ms:.3f} steps/s (runs {listed(runs["fed"])})'
          f'; the wait for the next batch {wait_ms:.3f} ms a step (runs '
          f'{listed(waits)}); the first batch of an epoch, from a new '
          f'loader, {float(np.mean(firsts)):.3f} ms (runs {listed(firsts)})')
    print(f'  copied (the same batches assembled beforehand, the pinned '
          f'copy, the step): {copied_ms:.3f} ms (runs '
          f'{listed(runs["copied"])}); bare (the same batches already on '
          f'the card): {bare_ms:.3f} ms = {1e3 / bare_ms:.3f} steps/s (runs '
          f'{listed(runs["bare"])})')
    print(f'  of a fed step: the copy {copied_ms - bare_ms:.3f} ms, the '
          f'loader {fed_ms - copied_ms:.3f} ms ({wait_ms:.3f} of it waiting '
          f'for a batch, {fed_ms - copied_ms - wait_ms:.3f} the step slowed '
          f'beside the producer threads); loader and copy '
          f'{100 * (fed_ms - bare_ms) / fed_ms:.1f} % of a fed step')
    for name, value in copy_times.items():
        print(f'  copy of the largest batch ({megabytes:.2f} MB), {name}: '
              f'{value:.4f} ms (runs {listed(copy_runs[name], 4)}); {card}')
    print(f'  host assembly of a batch alone ({config.train.batch_size} '
          f'patterns read and collated, an epoch\'s {len(assembled)} '
          f'batches): '
          f'{assembly_ms:.3f} ms a batch; {card}')
    return {'fed_step_ms': fed_ms, 'copied_step_ms': copied_ms,
            'bare_step_ms': bare_ms, 'runs_ms': runs,
            'loader_wait_ms': wait_ms, 'first_batch_ms': firsts,
            'copy_ms': copy_times, 'copy_mb': megabytes,
            'assembly_ms': assembly_ms}


def run_trainer_phase(config, device, card):
    """The trainer on pattern archives written here: run A (4 steps)
    against run B (2 steps, a new trainer restoring ``S_2.pt``, 2 more),
    the checkpoint directory served by ``Inferencer``, the launches of
    each part of the trainer's path, and its timings."""
    import shutil
    import tempfile

    from glow_tts_tpu_torch import Inferencer
    root = tempfile.mkdtemp(prefix='chip_smoke_trainer_')
    try:
        write_archive(os.path.join(root, 'train'), TRAIN_PATTERNS, config,
                      SEED + 20)
        write_archive(os.path.join(root, 'eval'), EVAL_PATTERNS, config,
                      SEED + 21)
        with open(os.path.join(root, 'sentences.tsv'), 'w') as f:
            f.write('Label\tText\tScale\tSpeaker\tGE2E\tProsody\tPitch\n')
            for i, text in enumerate(INFERENCE_TEXTS):
                f.write(f'T{i}\t{text}\t1.0\t0\tNone\tNone\tNone\n')

        counts = PartCounts()
        a = new_trainer(config, root, 'a', TRAINER_STEPS, device, counts)
        # the runs hold the trainer's own cuDNN setting, as a user's do
        assert torch.backends.cudnn.deterministic, 'Trainer left cuDNN free'
        a.train()
        free = a.free_running
        assert torch.isfinite(free['mels']).all(), 'free-running decode'
        assert a.checkpoints.steps() == list(range(
            SAVE_EVERY, TRAINER_STEPS + 1, SAVE_EVERY)), a.checkpoints.steps()
        b = new_trainer(config, root, 'b', RESUME_STEP, device)
        b.train()
        b = new_trainer(config, root, 'b', TRAINER_STEPS, device)
        assert b.step == RESUME_STEP, b.step
        b.train()
        errs, equal = compare_runs(a, b)
        worst = max(value for value, _ in errs.values())
        print(f'trainer, run A ({TRAINER_STEPS} steps) against run B '
              f'({RESUME_STEP} steps, a new trainer restoring '
              f'S_{RESUME_STEP}.pt, {TRAINER_STEPS - RESUME_STEP} more), '
              f'cuDNN deterministic as the trainer sets it: largest '
              f'difference by group, relative '
              f'to its max-abs: ' + '; '.join(
                  f'{group} {value:.3e} ({name})'
                  for group, (value, name) in errs.items())
              + f'; bit-equal: {equal}')
        assert worst <= RESUME_REL_BOUND, errs

        steps = config.decoder.stack
        flow = ROUTES[config.flow_route]
        eval_batches = -(-EVAL_PATTERNS // config.train.batch_size)
        evaluations = TRAINER_STEPS // EVAL_EVERY + 1   # and one at step 0
        expected = {
            'trainer init': {flow: steps},
            'trainer train': {
                'mas': TRAINER_STEPS, 'train_fwd': steps * TRAINER_STEPS,
                'train_bwd': BWD_KERNELS_PER_FLOW_STEP * steps
                * TRAINER_STEPS},
            'trainer eval': {flow: steps * eval_batches * evaluations,
                             'mas': eval_batches * evaluations},
            'trainer decode': {flow: steps * evaluations},
            'trainer inference': {
                flow: steps * (TRAINER_STEPS // EVAL_EVERY)}}
        for part, want in expected.items():
            got = counts.by_part[part]
            print(f'  launches, {part}: {got}')
            assert got == {**no_launches(), **want}, (part, got)

        served_dir = os.path.join(root, 'served')
        results = Inferencer(a.config.checkpoint_path, None, device
                             ).inference_from_file(
            os.path.join(root, 'sentences.tsv'), served_dir)
        files = sorted(os.listdir(os.path.join(served_dir, 'NPY', 'Mel')))
        assert files == [f'T{i}.npy' for i in range(len(INFERENCE_TEXTS))], \
            files
        for result in results:
            mel = np.load(os.path.join(served_dir, 'NPY', 'Mel',
                                       f'{result["label"]}.npy'))
            assert mel.shape == (config.sound.mel_dim,
                                 result['mel'].shape[0]), mel.shape
            assert np.isfinite(mel).all() and mel.shape[1] > 0
        print(f'  served the checkpoint directory (config=None): '
              f'{len(files)} NPY mels, frames '
              f'{[r["mel"].shape[0] for r in results]}')
        del b

        counts.unwrap(a)
        times = time_fed_loop(a, root, config, device, card)
        start = time.perf_counter()
        path = a.save_checkpoint()
        save_ms = (time.perf_counter() - start) * 1e3
        save_mb = os.path.getsize(path) / 1e6
        torch.cuda.synchronize()
        start = time.perf_counter()
        a.evaluate()
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - start) * 1e3
        print(f'  CheckpointManager.save: {save_ms:.1f} ms for '
              f'{save_mb:.1f} MB; evaluate() ({EVAL_PATTERNS} patterns in '
              f'{eval_batches} batches and the free-running decode): '
              f'{eval_ms:.1f} ms; {card}')
        print('trainer: ' + json.dumps({
            **times, 'save_ms': save_ms, 'save_mb': save_mb,
            'evaluate_ms': eval_ms, 'resume_max_rel_err': worst,
            'resume_bit_equal': equal, 'card': card}))
        return counts.by_part
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the conditioned modes: SE (look-up table or GE2E), PE and GR
# ---------------------------------------------------------------------------

GR_BATCH = 32              # the conditioned phase's serving batch
REF_FRAMES = 1000          # its longest prosody reference mel
MODE_BATCH = 8             # SE-LUT, SE-GE2E and PE: one batch each
CLASSIFIED_REL_BOUND = 1e-4


def mode_config(mode, route='fused', dtype='float32'):
    """The shipped YAML in ``mode`` (``'SE-LUT'``, ``'SE-GE2E'``, ``'PE'``,
    ``'GR'``) under ``route``, computing at ``dtype`` (float32, as the
    phases before the bfloat16 one pin it)."""
    import yaml
    from glow_tts_tpu_torch import load_config
    with open(CONFIG, encoding='utf-8') as f:
        data = yaml.safe_load(f)
    data['Mode'] = mode.split('-')[0]
    if mode == 'SE-GE2E':
        data['Speaker_Embedding']['Type'] = 'GE2E'
    return dataclasses.replace(load_config(data), coupling_backend=route,
                               compute_dtype=dtype)


def conditioned_items(config, texts, seed):
    """Serving items with what every mode reads, as arrays from ``seed``: a
    speaker id, a GE2E reference mel, a prosody reference mel (the first
    ``REF_FRAMES`` long, the others shorter) and a pitch track."""
    from glow_tts_tpu_torch.text import text_filtering
    rng = np.random.default_rng(seed)
    a, m = config.sound.max_abs_mel, config.sound.mel_dim
    return [{'label': f'c{i}', 'text': text_filtering(text),
             'speaker_id': int(rng.integers(
                 config.speaker_embedding.num_speakers)),
             'mel_for_ge2e': rng.uniform(
                 -a, a, (int(rng.integers(100, 400)), m)).astype(np.float32),
             'mel_for_prosody': rng.uniform(
                 -a, a, (REF_FRAMES if i == 0 else
                         int(rng.integers(REF_FRAMES // 4, REF_FRAMES)), m)
             ).astype(np.float32),
             'pitch': rng.random(int(rng.integers(REF_FRAMES // 5, REF_FRAMES))
                                 ).astype(np.float32)}
            for i, text in enumerate(texts)]


def prior_of(inferencer, items):
    """Phase 1 of serving on ``items`` through the inferencer's own batch."""
    batch = inferencer.batch(items)
    prior = inferencer.model.inference_prior(
        batch['tokens'], batch['token_lengths'], batch['length_scales'],
        batch.get('mels_for_prosody'), batch.get('mel_lengths_for_prosody'),
        batch.get('speakers'), batch.get('mels_for_ge2e'))
    return batch, prior


@torch.no_grad()
def check_pitch_kernels(model, device, eval_mask):
    """The pitch instantiations of #3, #2 and #4 against their plain
    versions at B = 32, T = 512, all frames valid and on the eval batch's
    ragged mask, both directions, on a GR model's weights and per-sample
    conditioning rows; #4's z bit for bit against 12 chained launches of #3
    with pitch.  Each is timed beside its Vanilla instantiation on the same
    inputs (Vanilla, pitch, pitch, Vanilla), with its plain version and the
    bounds of the work on the valid frames (the pitch term adds 2 · ps ·
    2ch operations a frame and layer, and the pitch operand's bytes)."""
    from glow_tts_tpu_torch.ops.coupling import (
        WEIGHT_KEYS, coupling, coupling_reference, flow_stack,
        flow_stack_reference, flow_step, flow_step_reference, kernel_keys)
    decoder = model.layer_Dict['Decoder']
    flows = list(decoder.layer_Dict['Flows'])
    step = flows[0]
    c = step.layers[0].logs.shape[1]
    gen = torch.Generator().manual_seed(SEED + 20)
    x, _ = ragged_batch(gen, GR_BATCH, 512, c, device)
    speakers = torch.randint(model.config.speaker_embedding.num_speakers,
                             (GR_BATCH,), generator=gen).to(device)
    prosody = (torch.randn((GR_BATCH, model.config.prosody_encoder.size),
                           generator=gen) * 0.3).to(device)
    cond = decoder.conditioning(GR_BATCH, model.layer_Dict['LUT'](speakers),
                                prosody, pitch=True)     # [S, n, B, 2ch]
    ps = model.config.decoder.num_squeeze
    pitch = torch.rand((GR_BATCH, 512, ps), generator=gen).to(device)
    xe = (x[:, :eval_mask.shape[1]] * eval_mask).contiguous()
    shapes = {'decode': (x, torch.ones_like(x[..., :1])),
              'eval': (xe, eval_mask)}
    stacked = {r: decoder.stacked_weights(r) for r in (False, True)}
    own = {**coupling_weights(step.weights(False)),
           'w_pitch': step.weights(False)['w_pitch']}
    n, ch2 = own['w_pitch'].shape[0], own['w_pitch'].shape[-1]
    pitch_flops = 2 * ps * ch2 * n          # a frame and step

    def weight_count(weights):
        return sum(weights[key].numel() for key in kernel_keys(
            (*WEIGHT_KEYS, 'ld_const', 'w_pitch')) if key in weights)

    kernels = {
        'flow_step': (
            1, lambda xs, m: 4 * (2 * xs.numel() + m.numel() + cond[0].numel()
                                  + xs.shape[0] + pitch.numel()
                                  + weight_count(step.weights(False))),
            step_frame_flops(step.weights(False)),
            lambda xs, m, r, p: flow_step(xs, m, step.weights(r), cond[0], r,
                                          pitch=p),
            lambda xs, m, r, p: flow_step_reference(xs, m, step.weights(r),
                                                    cond[0], r, p), 20),
        'coupling': (
            1, lambda xs, m: 4 * (xs.numel() + xs.numel() // 2 + m.numel()
                                  + cond[0].numel() + xs.shape[0]
                                  + pitch.numel() + weight_count(own)),
            step_frame_flops(own),
            lambda xs, m, r, p: coupling(xs[..., :c // 2], xs[..., c // 2:],
                                         m, own, cond[0], pitch=p, reverse=r),
            lambda xs, m, r, p: coupling_reference(
                xs[..., :c // 2], xs[..., c // 2:], m, own, cond[0], p, r),
            20),
        'flow_stack': (
            len(flows), lambda xs, m: 4 * (2 * xs.numel() + m.numel()
                                           + cond.numel() + xs.shape[0]
                                           + pitch.numel()
                                           + weight_count(stacked[False])),
            step_frame_flops(step.weights(False)),
            lambda xs, m, r, p: flow_stack(xs, m, stacked[r], cond, p, r),
            lambda xs, m, r, p: flow_stack_reference(xs, m, stacked[r], cond,
                                                     p, r), 5)}
    rows = {}
    for name, (steps, moved, frame_flops, kernel_fn, plain_fn,
               iters) in kernels.items():
        row = {'max_abs_err': 0.0}
        for shape, (xs, m) in shapes.items():
            for reverse in (False, True):
                z_k, ld_k = kernel_fn(xs, m, reverse, pitch)
                z_p, ld_p = plain_fn(xs, m, reverse, pitch)
                torch.cuda.synchronize()
                err, rel = (z_k - z_p).abs().max().item(), rel_err(z_k, z_p)
                line = (f'{name} pitch instantiation vs plain, {shape} shape '
                        f'reverse={reverse}: max abs err {err:.3e}, max rel '
                        f'err {rel:.3e}')
                assert torch.isfinite(z_k).all(), line
                assert rel < Z_REL_BOUND, line
                if not reverse:
                    ld_rel = rel_err(ld_k, ld_p)
                    line += f', logdet rel err {ld_rel:.3e}'
                    assert ld_rel < LD_REL_BOUND, line
                if name == 'flow_stack':
                    chained = xs
                    for k in (reversed(range(steps)) if reverse
                              else range(steps)):
                        chained, _ = flow_step(chained, m,
                                               flows[k].weights(reverse),
                                               cond[k], reverse, pitch=pitch)
                    same = torch.equal(z_k, chained)
                    line += (f'; z bit-equal to {steps} chained flow-step '
                             f'launches with pitch: {same}')
                    assert same, line
                print(line)
                row['max_abs_err'] = max(row['max_abs_err'], err)
            valid = m.sum().item()
            flops = (frame_flops + pitch_flops) * valid * steps
            bounds = body_bounds(moved(xs, m), flops)
            vanilla_bounds = body_bounds(moved(xs, m) - 4 * pitch.numel(),
                                         frame_flops * valid * steps)
            for reverse in (True, False):
                pitch_ms, vanilla_ms = paired_ms(
                    lambda: kernel_fn(xs, m, reverse, pitch),
                    lambda: kernel_fn(xs, m, reverse, None), iters)
                plain_ms = cuda_ms(lambda: plain_fn(xs, m, reverse, pitch),
                                   1, 1)
                print(f'{name} {shape} shape ({int(valid)} valid frames) '
                      f'reverse={reverse}: pitch instantiation {pitch_ms:.4f}'
                      f' ms, Vanilla instantiation {vanilla_ms:.4f} ms on '
                      f'the same inputs (bound {vanilla_bounds["bound_ms"]:.4f}'
                      f'), plain with pitch {plain_ms:.4f} ms; bound '
                      f'{bounds["bound_ms"]:.4f} ms by {bounds["bound_by"]} '
                      f'at the TF32 peak ({bounds["fma_bound_ms"]:.4f} ms at '
                      f'the f32 FMA peak)')
                key = ('' if shape == 'decode' else 'eval_shape_') + (
                    '' if reverse else 'forward_')
                row.update({f'{key}ms': pitch_ms,
                            f'{key}vanilla_ms': vanilla_ms,
                            f'{key}plain_ms': plain_ms})
            if shape == 'decode':
                row.update(bounds)
            else:
                row['eval_shape_bound_ms'] = bounds['bound_ms']
        rows[name] = row
    return rows


def serve_gr(inferencers, vanilla_models, device):
    """GR serving at B = 32 in the 1024-frame bucket under each route,
    through ``Inferencer.synthesize_items`` (counted), the decode through
    the kernels against their plain versions and between the routes, timed
    beside a Vanilla model's decode of the same tokens and durations (so
    the same valid frames), with a profiler window; and the prior phase
    alone (the GST over reference mels of up to 1000 frames, the
    encoder)."""
    config = inferencers['fused'].config
    items = conditioned_items(config, [INFERENCE_TEXTS[i % 4]
                                       for i in range(GR_BATCH)], SEED + 30)
    # one length scale that puts the longest request near 960 frames
    _, prior = prior_of(inferencers['fused'], items)
    scale = 960.0 / prior['durations'].sum(dim=1).max().item()
    items = [dict(item, length_scale=scale) for item in items]
    by_path, mels = {}, {}
    for route, inferencer in inferencers.items():
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        expected = route_launches(route, config, 1, pitch=True)
        print(f'GR: served {len(results)} requests in one decode under '
              f'{route!r}: launches {launches}')
        assert launches == expected, (launches, expected)
        for r in results:
            assert r['bucket'] == 1024, r['bucket']
            assert np.isfinite(r['mel']).all(), r['label']
            assert (r['attention'].sum(axis=0) == 1).all(), r['label']
        by_path[f'serve GR {route}'] = launches

        model = inferencer.model
        batch, prior = prior_of(inferencer, items)
        noise = torch.randn((GR_BATCH, 1024, config.sound.mel_dim),
                            generator=torch.Generator(device=device)
                            .manual_seed(SEED + 31), device=device)
        pitch_args = {'pitches': batch['pitches'],
                      'pitch_lengths': batch['pitch_lengths']}
        out_k = model.inference_decode(prior, noise=noise,
                                       max_mel_length=1024, **pitch_args)
        out_p = model.inference_decode(prior, noise=noise,
                                       max_mel_length=1024, **pitch_args,
                                       **plain_flow_fns())
        valid = (torch.arange(1024, device=device)[None, :]
                 < out_k['mel_lengths'][:, None])[..., None]
        denom = valid.sum() * config.sound.mel_dim

        def mae(a, b):
            return (((a - b).abs() * valid).sum() / denom).item()

        kernel_mae = mae(out_k['mels'], out_p['mels'])
        mels[route] = out_k['mels']
        line = (f'GR decode under {route!r} B={GR_BATCH} bucket 1024 '
                f'({int(valid.sum())} valid frames), kernels vs plain: mel '
                f'MAE {kernel_mae:.3e}')
        if route != 'fused':
            between = mae(out_k['mels'], mels['fused'])
            line += f'; vs \'fused\' {between:.3e}'
            assert between < MEL_MAE_BOUND, line
        print(line)
        assert kernel_mae < MEL_MAE_BOUND, line

        gen = torch.Generator(device=device)
        vanilla = vanilla_models[route]
        vanilla_prior = {**vanilla.inference_prior(
            batch['tokens'], batch['token_lengths'], batch['length_scales']),
            'durations': prior['durations']}
        gr_ms, vanilla_ms = paired_ms(
            lambda: model.inference_decode(prior, generator=gen,
                                           max_mel_length=1024, **pitch_args),
            lambda: vanilla.inference_decode(vanilla_prior, generator=gen,
                                             max_mel_length=1024), 5)
        idle = profile_window(
            f'GR decodes under {route!r}',
            lambda: model.inference_decode(prior, generator=gen,
                                           max_mel_length=1024, **pitch_args),
            3)
        print(f'GR decode phase under {route!r} B={GR_BATCH} bucket 1024: '
              f'{gr_ms:.3f} ms ({GR_BATCH * 1024 / gr_ms * 1e3:.0f} mel '
              f'frames/s of capacity), device idle '
              f'{100 * (idle or 0):.1f} % of its window; a Vanilla decode '
              f'of the same valid frames in the same call {vanilla_ms:.3f} '
              f'ms')

    model = inferencers['fused'].model
    batch = inferencers['fused'].batch(items)
    gst = model.layer_Dict['Prosody_Encoder']
    prior_ms = cuda_ms(lambda: prior_of(inferencers['fused'], items), 5)

    def gst_alone():
        with torch.no_grad():
            gst(batch['mels_for_prosody'], batch['mel_lengths_for_prosody'])

    gst_ms = cuda_ms(gst_alone, 5)
    vanilla_prior_ms = cuda_ms(lambda: vanilla_models['fused'].inference_prior(
        batch['tokens'], batch['token_lengths'], batch['length_scales']), 5)
    print(f'GR prior phase B={GR_BATCH} (reference mels of up to '
          f'{REF_FRAMES} frames, padded to '
          f'{batch["mels_for_prosody"].shape[1]}; {batch["tokens"].shape[1]} '
          f'token slots): {prior_ms:.3f} ms with the host\'s collation, the '
          f'GST alone {gst_ms:.3f} ms; the Vanilla prior of the same tokens '
          f'{vanilla_prior_ms:.3f} ms')
    return by_path


def serve_other_modes(device):
    """SE with the look-up table, SE with GE2E and PE, one batch of
    ``MODE_BATCH`` texts each through ``Inferencer`` (counted: the Vanilla
    instantiation of #3, 12 launches): finite mels whose lengths are the
    predicted durations' sums, cut as the decode cuts them."""
    from glow_tts_tpu_torch import Inferencer, random_state_dict
    by_path = {}
    for mode in ('SE-LUT', 'SE-GE2E', 'PE'):
        config = mode_config(mode)
        inferencer = Inferencer(random_state_dict(config, SEED), config,
                                device, batch_size=MODE_BATCH)
        items = conditioned_items(config, [INFERENCE_TEXTS[i % 4] for i in
                                           range(MODE_BATCH)], SEED + 40)
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        assert launches == route_launches('fused', config), launches
        _, prior = prior_of(inferencer, items)
        s = config.decoder.num_squeeze
        for r, total in zip(results, prior['durations'].sum(dim=1).tolist()):
            expected = max(int(min(max(total, 1), r['bucket'])) // s * s, s)
            assert r['mel'].shape[0] == expected, (mode, r['label'])
            assert np.isfinite(r['mel']).all(), (mode, r['label'])
            assert (r['attention'].sum(axis=0) == 1).all(), (mode, r['label'])
        print(f'{mode}: served {len(results)} requests through Inferencer, '
              f'mel frames {[r["mel"].shape[0] for r in results]}, launches '
              f'{launches}')
        by_path[f'serve {mode}'] = launches
    return by_path


def check_gr_forward(model, batch, device):
    """The deterministic GR forward on the eval batch (speakers and pitch
    tracks from the seed): kernels (#3 with pitch, MAS) against the plain
    versions, z and logdets to the kernel bars, the path equal in every
    element, the classifier's logits."""
    from glow_tts_tpu_torch.ops.mas import maximum_path_reference
    gen = torch.Generator().manual_seed(SEED + 50)
    b, t_mel = batch['mels'].shape[:2]
    extra = {'speakers': torch.randint(
                 model.config.speaker_embedding.num_speakers, (b,),
                 generator=gen).to(device),
             'pitches': torch.rand((b, t_mel), generator=gen).to(device)}
    args = (batch['tokens'], batch['token_lengths'], batch['mels'],
            batch['mel_lengths'])
    with torch.no_grad():
        zero_counts()
        out_k = model(*args, **extra)
        launches = read_counts()
        out_p = model(*args, **extra, mas_fn=maximum_path_reference,
                      **plain_flow_fns())
    expected = {**route_launches('fused', model.config, pitch=True), 'mas': 1}
    assert launches == expected, launches
    z_rel = rel_err(out_k['z'], out_p['z'])
    ld_rel = rel_err(out_k['log_dets'], out_p['log_dets'])
    same = torch.equal(out_k['attentions'], out_p['attentions'])
    cls_rel = rel_err(out_k['classified_speakers'],
                      out_p['classified_speakers'])
    line = (f'GR forward on the eval batch {tuple(batch["mels"].shape)}, '
            f'kernels vs plain: z rel err {z_rel:.3e}, logdet rel err '
            f'{ld_rel:.3e}, MAS path equal: {same}, classified speakers rel '
            f'err {cls_rel:.3e}; launches {launches}')
    print(line)
    assert z_rel < Z_REL_BOUND and ld_rel < LD_REL_BOUND, line
    assert same and cls_rel < CLASSIFIED_REL_BOUND, line
    return {'forward GR': launches}


def run_conditioned_phase(vanilla_models, eval_batch, eval_mask, device):
    """The conditioned modes at the shipped width, random weights from
    ``SEED``: the pitch instantiations' checks and times, GR serving under
    each route, SE (LUT, GE2E) and PE serving, the GR forward."""
    from glow_tts_tpu_torch import Inferencer, random_state_dict
    gr = mode_config('GR')
    state = random_state_dict(gr, SEED)
    inferencers = {route: Inferencer(
        state, dataclasses.replace(gr, coupling_backend=route), device,
        batch_size=GR_BATCH) for route in ROUTES}
    rows = check_pitch_kernels(inferencers['fused'].model, device, eval_mask)
    by_path = serve_gr(inferencers, vanilla_models, device)
    by_path.update(serve_other_modes(device))
    by_path.update(check_gr_forward(inferencers['fused'].model, eval_batch,
                                    device))
    return rows, by_path


# ---------------------------------------------------------------------------
# training the conditioned modes: GR (the pitch builds of #5 and #6), SE, PE
# ---------------------------------------------------------------------------

TRAIN_MODES = ('SE-LUT', 'SE-GE2E', 'PE')
MODE_TRAIN_STEPS = 2       # SE-LUT, SE-GE2E and PE: train steps each


def conditioned_batch(config, device, seed):
    """A training batch of the shipped shape (``synthetic_items``) with what
    every mode reads: seeded speaker ids, and pitch tracks a few frames
    shorter or longer than their mels, through ``TrainCollater``."""
    from glow_tts_tpu_torch import TrainCollater, batch_to_device
    from glow_tts_tpu_torch.text import Tokenizer
    rng = np.random.default_rng(seed)
    items = [dict(item, speaker_id=int(rng.integers(
                 config.speaker_embedding.num_speakers)),
                  pitch=rng.random(item['mel'].shape[0] + int(
                      rng.integers(-8, 9))).astype(np.float32))
             for item in synthetic_items(config, seed)]
    return batch_to_device(TrainCollater(config, Tokenizer())(items), device)


def pitch_stack_problem(model, batch, config):
    """The flow stack's operands as a GR train step hands them over: those
    of ``stack_problem`` (the weights with ``w_pitch``), the train route's
    conditioning rows of the batch's speaker and prosody vectors, and the
    squeezed pitch operand, detached."""
    from glow_tts_tpu_torch.models.layers import sequence_mask
    x, mask, weights = stack_problem(model, batch, config)
    decoder = model.layer_Dict['Decoder']
    with torch.no_grad():
        speaker, prosody, _ = model.conditions(
            batch['mels'], batch['mel_lengths'], batch.get('speakers'),
            batch.get('mels_for_ge2e'))
        cond = decoder.train_conditioning(x.shape[0], speaker, prosody, True)
        pitch = decoder._squeezed_pitch(
            batch['pitches'],
            sequence_mask(batch['mel_lengths'], batch['mels'].shape[1]))
    return x, mask, weights, cond, pitch


def check_train_pitch_forward(x, mask, weights, cond, pitch):
    """#5's pitch build against the plain version on a GR train step's
    operands, no gradient wanted, at rates 0.05 and 0."""
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    seed, worst = -20240301, 0.0
    with torch.no_grad():
        for rate in (FLOW_RATE, 0.0):
            z_k, ld_k = flow_stack_train(x, mask, weights, cond, pitch,
                                         seed=seed, dropout_rate=rate)
            z_p, ld_p = flow_stack_train_reference(x, mask, weights, cond,
                                                   pitch, seed=seed,
                                                   dropout_rate=rate)
            torch.cuda.synchronize()
            z_rel, ld_rel = rel_err(z_k, z_p), rel_err(ld_k, ld_p)
            line = (f'train forward pitch build vs plain {tuple(x.shape)}, '
                    f'{weights["w_in"].shape[0]} steps, cond and pitch, rate '
                    f'{rate}: z max abs err '
                    f'{(z_k - z_p).abs().max().item():.3e}, rel {z_rel:.3e}; '
                    f'logdet rel {ld_rel:.3e}')
            print(line)
            assert torch.isfinite(z_k).all() and torch.isfinite(ld_k).all()
            assert z_rel < TRAIN_Z_REL_BOUND, line
            assert ld_rel < TRAIN_LD_REL_BOUND, line
            worst = max(worst, (z_k - z_p).abs().max().item())
    return worst


def time_train_pitch_kernels(x, mask, weights, cond, pitch):
    """The pitch builds of #5 (storing, as a train step runs it) and #6
    per flow step beside the Vanilla builds on the same inputs (the same
    conditioning rows, no pitch; Vanilla, pitch, pitch, Vanilla), the
    plain version with pitch, and the bounds of the work on the valid
    frames (the pitch term adds 2 · ps · 2ch operations a frame and layer
    forward, twice that backward, and the pitch operand's bytes)."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    gen = torch.Generator().manual_seed(SEED + 61)
    dz = torch.randn(x.shape, generator=gen).to(x.device)
    dld = torch.ones(x.shape[0], device=x.device)
    s_steps, n, _, ch, ch2 = weights['w_in'].shape

    def parts(fn, with_pitch):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl, cl = x.clone().requires_grad_(), cond.clone().requires_grad_()
        p = pitch if with_pitch else None
        inputs = [xl, cl, *(leaves[key] for key in
                            coupling_grad.weight_keys(with_pitch))]

        def forward():
            return fn(xl, mask, leaves, cl, p, seed=SEED,
                      dropout_rate=FLOW_RATE)
        z, ld = forward()

        def backward():
            torch.autograd.grad((z, ld), inputs, (dz, dld),
                                retain_graph=True)
        return forward, backward

    fwd_p, bwd_p = parts(flow_stack_train, True)
    fwd_v, bwd_v = parts(flow_stack_train, False)
    fwd_ms, fwd_vanilla = paired_ms(fwd_p, fwd_v, 3)
    bwd_ms, bwd_vanilla = paired_ms(bwd_p, bwd_v, 3)
    fwd_plain, bwd_plain = parts(flow_stack_train_reference, True)
    plain_fwd_ms = cuda_ms(fwd_plain, 2, 1)
    plain_bwd_ms = cuda_ms(bwd_plain, 2, 1)

    per_step = {key: value[0] for key, value in weights.items()}
    valid = mask.sum().item()
    pitch_flops = 2 * pitch.shape[-1] * ch2 * n
    flops = (step_frame_flops(per_step) + pitch_flops) * valid
    weight_count = sum(value.numel() for value in per_step.values())
    moved = 4 * (2 * x.numel() + mask.numel() + x.shape[0] + weight_count
                 + cond[0].numel() + pitch.numel())
    fwd_bounds = body_bounds(moved, flops)
    saved_bytes = coupling_grad.saved_bytes_per_step(
        x.shape[0] * x.shape[1], x.shape[2], ch, n)
    bwd_bytes = saved_bytes + 4 * (3 * x.numel() + mask.numel() + x.shape[0]
                                   + 2 * weight_count + 2 * cond[0].numel()
                                   + 2 * pitch.numel())
    bwd_bound = bound(bwd_bytes, 2 * flops, PEAK_TF32_FLOP_PER_S)
    fwd_row = {'ms': fwd_ms / s_steps, 'vanilla_ms': fwd_vanilla / s_steps,
               'plain_ms': plain_fwd_ms / s_steps, **fwd_bounds}
    bwd_row = {'ms': bwd_ms / s_steps, 'vanilla_ms': bwd_vanilla / s_steps,
               'plain_ms': plain_bwd_ms / s_steps, 'bound_ms': bwd_bound[0],
               'bound_by': bwd_bound[1]}
    for name, row in (('#5 forward, storing', fwd_row),
                      ('#6 backward', bwd_row)):
        print(f'{name}, per flow step, {tuple(x.shape)} ({int(valid)} valid '
              f'frames), cond and pitch: pitch build {row["ms"]:.4f} ms, '
              f'Vanilla build {row["vanilla_ms"]:.4f} ms on the same inputs '
              f'({100 * (row["ms"] / row["vanilla_ms"] - 1):+.1f} %), plain '
              f'with pitch {row["plain_ms"]:.4f} ms; bound '
              f'{row["bound_ms"]:.4f} ms by {row["bound_by"]} at the TF32 '
              f'peak')
    return fwd_row, bwd_row


def time_conditioned_steps(config, batches, vanilla_config, device):
    """The GR train step by events beside a Vanilla step on the same batch
    (Vanilla, GR, GR, Vanilla), a profiler window of GR steps (device work
    and idle share), its peak memory; and one timing each of SE-LUT,
    SE-GE2E and PE steps, each on its mode's batch of the same texts and
    mels."""
    from glow_tts_tpu_torch import (make_optimizer, make_train_step,
                                    random_state_dict)
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    batch = batches['GR']

    def stepper(cfg, batch=batch):
        model = train_model(random_state_dict(cfg, SEED), cfg, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  **conditioning_inputs(batch))
        step = make_train_step(
            cfg, model, make_optimizer(cfg, model.parameters()), seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED))
        return lambda: step(batch), model

    (gr_step, model), (vanilla_step, _) = stepper(config), stepper(
        vanilla_config)
    gr_ms, vanilla_ms = paired_ms(gr_step, vanilla_step, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gr_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f'GR train step {tuple(batch["mels"].shape)}: {gr_ms:.3f} ms by '
          f'events, a Vanilla step on the same batch {vanilla_ms:.3f} ms '
          f'({100 * (gr_ms / vanilla_ms - 1):+.1f} %); peak memory of a GR '
          f'step {peak / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f} held before)')
    idle = profile_window('GR train steps', gr_step, 3, warmup=1)
    times = {'gr_step_ms': gr_ms, 'vanilla_step_ms': vanilla_ms,
             'gr_step_idle': idle, 'gr_peak_gib': peak / 2 ** 30}

    # what GR adds to a step, each part alone, forward and backward
    decoder = model.layer_Dict['Decoder']
    mels, lengths = batch['mels'], batch['mel_lengths']

    def conditions_both():
        speaker, prosody, classified = model.conditions(
            mels, lengths, batch['speakers'])
        (speaker.sum() + prosody.sum() + classified.sum()).backward()

    width = config.speaker_embedding.embedding_size     # = the prosody's

    def rows_both():
        vector = torch.ones((mels.shape[0], width), device=device)
        rows = decoder.train_conditioning(mels.shape[0], vector, vector,
                                          True)
        w_pitch = decoder._stacked_layer_convs('Pitch')[0]
        (rows.sum() + w_pitch.sum()).backward()

    for name, fn in (('LUT, GST and classifier', conditions_both),
                     ('train rows and w_pitch', rows_both)):
        times[f'gr_part_{name}_ms'] = cuda_ms(fn, 5)
        print(f'  GR train part, {name}, forward + backward: '
              f'{times[f"gr_part_{name}_ms"]:.4f} ms')
    del gr_step, vanilla_step, model
    for mode in TRAIN_MODES:
        step, _ = stepper(mode_config(mode), batches[mode])
        times[f'{mode}_step_ms'] = cuda_ms(step, 2, 1)
        print(f'{mode} train step, same batch: '
              f'{times[f"{mode}_step_ms"]:.3f} ms by events')
    return times


def run_gr_trainer_resume(config, device):
    """A GR ``Trainer`` on archives with speakers and pitch tracks: run A
    (4 steps) against run B (2 steps, a new trainer restoring ``S_2.pt``,
    2 more), within ``RESUME_REL_BOUND`` by group; its launches by part."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix='chip_smoke_gr_trainer_')
    try:
        write_archive(os.path.join(root, 'train'), TRAIN_PATTERNS, config,
                      SEED + 70, conditioned=True)
        write_archive(os.path.join(root, 'eval'), EVAL_PATTERNS, config,
                      SEED + 71, conditioned=True)
        # GR serves a TSV only with reference wavs (run_wav_phase serves
        # GR from wavs): no inference runs here
        counts = PartCounts()
        a = new_trainer(config, root, 'a', TRAINER_STEPS, device, counts,
                        inference=False)
        a.train()
        assert torch.isfinite(a.free_running['mels']).all()
        new_trainer(config, root, 'b', RESUME_STEP, device,
                    inference=False).train()
        b = new_trainer(config, root, 'b', TRAINER_STEPS, device,
                        inference=False)
        assert b.step == RESUME_STEP, b.step
        b.train()
        errs, equal = compare_runs(a, b)
        worst = max(value for value, _ in errs.values())
        print(f'GR trainer, run A ({TRAINER_STEPS} steps) against run B '
              f'({RESUME_STEP} steps, a new trainer restoring '
              f'S_{RESUME_STEP}.pt, {TRAINER_STEPS - RESUME_STEP} more): '
              f'largest difference by group, relative to its max-abs: '
              + '; '.join(f'{group} {value:.3e} ({name})'
                          for group, (value, name) in errs.items())
              + f'; bit-equal: {equal}')
        assert worst <= RESUME_REL_BOUND, errs
        assert 'Loss/speaker' in a.writers['train'].scalars
        train = counts.by_part['trainer train']
        print(f'  launches, GR trainer train: {train}')
        assert train == {**no_launches(), 'mas': TRAINER_STEPS,
                         'train_fwd_pitch': config.decoder.stack
                         * TRAINER_STEPS,
                         'train_bwd_pitch': BWD_PITCH_KERNELS_PER_FLOW_STEP
                         * config.decoder.stack * TRAINER_STEPS}, train
        return {f'GR {part}': value for part, value in counts.by_part.items()
                if part != 'trainer inference'}, worst, equal
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_conditioned_training(vanilla_config, device):
    """Training in the conditioned modes at the shipped width and training
    shape: the pitch builds of #5 and #6 against their plain version and
    timed beside the Vanilla builds; GR trained through the kernels and
    through the plain versions from the same weights; SE-LUT, SE-GE2E and
    PE trained; the steps timed; a GR trainer's resume."""
    from glow_tts_tpu_torch import random_state_dict
    gr = mode_config('GR')
    # one batch of the same texts and mels for each mode, with its fields
    batches = {mode: conditioned_batch(mode_config(mode), device, SEED + 80)
               for mode in ('GR',) + TRAIN_MODES}
    batch = batches['GR']
    model = train_model(random_state_dict(gr, SEED), gr, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              speakers=batch['speakers'],
                              pitches=batch['pitches'])
    problem = pitch_stack_problem(model, batch, gr)
    del model
    fwd_err = check_train_pitch_forward(*problem)
    bwd_err = check_train_backward(*problem)
    fwd_row, bwd_row = time_train_pitch_kernels(*problem)
    del problem
    by_path = {'train GR': run_training(gr, batch, device)}
    for mode in TRAIN_MODES:
        by_path[f'train {mode}'] = run_training(
            mode_config(mode), batches[mode], device, MODE_TRAIN_STEPS,
            plain=False)
    times = time_conditioned_steps(gr, batches, vanilla_config, device)
    trainer_paths, resume_err, resume_equal = run_gr_trainer_resume(gr,
                                                                    device)
    by_path.update(trainer_paths)
    print('conditioned training: ' + json.dumps({
        **times, 'gr_resume_max_rel_err': resume_err,
        'gr_resume_bit_equal': resume_equal}))
    return ({'flow_train_fwd': {'max_abs_err': fwd_err, **fwd_row},
             'flow_train_bwd': {'max_abs_err': bwd_err, **bwd_row}},
            by_path)


# ---------------------------------------------------------------------------
# MiniSpeech: the repo's converged recipe, at 80 flow channels
# ---------------------------------------------------------------------------

MINISPEECH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'configs', 'MiniSpeech.yaml')
# its vocabulary (Encoder.Embedding_Tokens 13): <S>, <E>, the space (the
# pause, Train.Anchor_Pause_Tokens [2]) and ten letters
MS_VOCAB = ['<S>', '<E>', ' '] + list('ABCDEFGHIJ')
MS_BATCH = 32                  # Train.Batch_Size
MS_TOKENS = (5, 40)            # tokens of an utterance, <S> and <E> included
MS_FRAMES = (50, 600)          # its mel frames (Train_Pattern.Mel_Length)
MS_SILENCE = -3.9              # a pause frame's channel mean (anchor -3.5)
EM_STATS_REL_BOUND = 1e-4      # em_stats of kernels vs plain, per tensor
# the curriculum steps run through the kernels and the plain versions, in
# order: (warmup path, frozen decoder)
CURRICULUM = (('em', True),) * 3 + ((None, False), ('anchored', False),
                                    ('linear', False))
MS_TRAINER_STEPS, MS_RESUME_STEP = 4, 1
MS_WARM_STEPS = 2              # Alignment_Warmup_Steps = Decoder_Freeze_Steps


def minispeech_config(root, dtype='float32'):
    """``configs/MiniSpeech.yaml`` with its token dictionary (written here)
    and its outputs under ``root``, and its pattern sets ``root/train``
    and ``root/eval`` (its own length filters), computing at ``dtype``: the
    YAML asks for bfloat16, which the bfloat16 phase runs; the phases
    before it pin float32."""
    import yaml
    from glow_tts_tpu_torch import load_config
    config = dataclasses.replace(load_config(MINISPEECH),
                                 compute_dtype=dtype)
    token_path = os.path.join(root, 'Token.yaml')
    with open(token_path, 'w', encoding='utf-8') as f:
        yaml.safe_dump({token: i for i, token in enumerate(MS_VOCAB)}, f)
    train = config.train
    train = dataclasses.replace(
        train, train_pattern=dataclasses.replace(
            train.train_pattern, path=os.path.join(root, 'train')),
        eval_pattern=dataclasses.replace(
            train.eval_pattern, path=os.path.join(root, 'eval')))
    config = dataclasses.replace(
        config, token_path=token_path, train=train,
        checkpoint_path=os.path.join(root, 'checkpoint'),
        log_path=os.path.join(root, 'log'),
        inference_path=os.path.join(root, 'inference'))
    dec, wavenet = config.decoder, config.decoder.affine_coupling.wavenet
    shape = (config.sound.mel_dim, dec.num_squeeze, dec.stack,
             wavenet.num_layers, wavenet.kernel_size,
             dec.affine_coupling.calc_channels,
             config.encoder.embedding_tokens, config.train.batch_size)
    assert shape == (80, 1, 12, 4, 5, 192, len(MS_VOCAB), MS_BATCH), shape
    assert (train.alignment_warmup_mode, train.anchor_pause_tokens,
            train.alignment_warmup_steps, train.decoder_freeze_steps) == (
        'em', (MS_VOCAB.index(' '),), 5000, 5000)
    return config


def minispeech_items(n, seed, text_min=MS_TOKENS[0] - 2):
    """``n`` utterances of the MiniSpeech vocabulary with tokens (``<S>`` and
    ``<E>`` included) and frames spread over ``MS_TOKENS`` and
    ``MS_FRAMES``: words of letters between single spaces, each token
    owning a random run of frames; a letter's frames carry its id's mel
    signature with noise, a space's (and ``<S>``'s, ``<E>``'s) are silent
    (channel mean about ``MS_SILENCE``), so the anchored path has pins."""
    rng = np.random.default_rng(seed)
    signatures = np.random.default_rng(SEED + 90).normal(
        0.0, 1.5, (len(MS_VOCAB), 80))
    items = []
    for n_tok, n_mel in zip(
            rng.permutation(np.linspace(text_min + 2, MS_TOKENS[1], n
                                        ).round().astype(int)),
            rng.permutation(np.linspace(*MS_FRAMES, n).round().astype(int))):
        ids = rng.integers(3, len(MS_VOCAB), n_tok - 2)
        ids[rng.random(n_tok - 2) < 0.25] = 2
        ids[0] = ids[-1] = 3 + rng.integers(len(MS_VOCAB) - 3)
        for i in range(1, len(ids)):             # no two spaces in a row
            if ids[i] == 2 and ids[i - 1] == 2:
                ids[i] = 3
        tokens = np.concatenate([[0], ids, [1]])
        cuts = np.sort(rng.choice(np.arange(1, n_mel), n_tok - 1,
                                  replace=False))
        owner = np.searchsorted(cuts, np.arange(n_mel), side='right')
        frame_ids = tokens[owner]
        silent = frame_ids < 3
        mel = np.where(silent[:, None],
                       MS_SILENCE + 0.05 * rng.standard_normal((n_mel, 80)),
                       signatures[frame_ids]
                       + 0.3 * rng.standard_normal((n_mel, 80)))
        items.append({'text': ''.join(MS_VOCAB[i] for i in ids),
                      'mel': np.clip(mel, -4.0, 4.0).astype(np.float32)})
    return items


def minispeech_batch(config, device):
    """A batch of the recipe's shape through ``TrainCollater``: B = 32,
    tokens 5 … 40 padded to 64, frames 50 … 600 padded to 640."""
    from glow_tts_tpu_torch import TrainCollater, batch_to_device
    from glow_tts_tpu_torch.text import Tokenizer, load_token_dict
    collater = TrainCollater(config, Tokenizer(load_token_dict(
        config.token_path)))
    batch = batch_to_device(collater(minispeech_items(MS_BATCH, SEED + 92)),
                            device)
    assert tuple(batch['tokens'].shape) == (MS_BATCH, 64), batch['tokens'].shape
    assert tuple(batch['mels'].shape) == (MS_BATCH, 640, 80)
    lengths = (batch['token_lengths'].min().item(),
               batch['token_lengths'].max().item(),
               batch['mel_lengths'].min().item(),
               batch['mel_lengths'].max().item())
    assert lengths == (*MS_TOKENS, *MS_FRAMES), lengths
    return batch


def write_minispeech_archive(path, n, config, seed):
    """``n`` patterns of :func:`minispeech_items` with the port's pattern
    IO, texts long enough for the recipe's length filter."""
    from glow_tts_tpu_torch.data.patterns import (build_metadata,
                                                  save_metadata, save_pattern)
    items = minispeech_items(
        n, seed, text_min=config.train.train_pattern.text_length_min)
    for i, item in enumerate(items):
        save_pattern(os.path.join(path, f'P{i:03d}.PICKLE'), {
            'Audio': np.zeros(item['mel'].shape[0], np.float32),
            'Mel': item['mel'], 'Pitch': np.zeros(item['mel'].shape[0],
                                                  np.float32),
            'Speaker_ID': 0, 'Speaker': 'MiniSpeech',
            'Dataset': 'Synthetic', 'Text': item['text']})
    save_metadata(path, build_metadata(path, config.sound))


def curriculum_step_fns(config, model, optimizer, em, stack_fn, mas_fn,
                        generator=None):
    """The curriculum's step variants of ``CURRICULUM`` over one model,
    optimiser, encoder dropout generator (seeded here unless given) and EM
    holder, as the trainer builds them."""
    from glow_tts_tpu_torch import make_train_step
    if generator is None:
        generator = torch.Generator(device=next(model.parameters()).device
                                    ).manual_seed(SEED)
    return {(mode, frozen): make_train_step(
        config, model, optimizer, seed=SEED, generator=generator,
        stack_fn=stack_fn, mas_fn=mas_fn,
        linear_alignment=mode == 'linear',
        anchored_alignment=mode == 'anchored', em_alignment=mode == 'em',
        freeze_decoder=frozen, em_state=em)
        for mode, frozen in set(CURRICULUM)}


def run_curriculum_steps(config, batch, state, device):
    """3 EM steps with the decoder frozen, 1 released (learned-prior MAS),
    1 anchored and 1 linear step at MiniSpeech's width through the
    kernels; before each, the plain versions' model takes the kernels'
    model's state (weights, optimiser, EM statistics, generator) and runs
    the same step, so that both start it from the same bits (after a step
    their weights differ in the last bits, which moves the encoder's ReLU
    kinks: gradients of later steps cannot be compared across two runs).
    Bars: every MAS path equal, losses within 1e-4 and the gradient norm
    within 1e-3, the gradients within 1e-4 of their max-abs, ``em_stats``
    within 1e-4, and the frozen decoder's weights bit-unchanged over the
    frozen steps on both sides while its moments moved.  Returns the
    kernels' launches."""
    from glow_tts_tpu_torch import make_optimizer
    from glow_tts_tpu_torch.ops.coupling import flow_step
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from glow_tts_tpu_torch.training.step import EMState, init_em_stats
    sides = {}
    for name, stack_fn, mas_fn in (
            ('kernels', flow_stack_train, maximum_path),
            ('plain', flow_stack_train_reference, maximum_path_reference)):
        model = train_model(state, config, device)
        optimizer = make_optimizer(config, model.parameters())
        em = EMState(init_em_stats(config, device))
        generator = torch.Generator(device=device).manual_seed(SEED)
        paths = []

        def recording(log_p, token_lengths, mel_lengths, mas_fn=mas_fn,
                      paths=paths):
            path = mas_fn(log_p, token_lengths, mel_lengths)
            paths.append(path)
            return path

        seen = []
        forward = model.forward

        def keeping(*args, forward=forward, seen=seen, **kwargs):
            out = forward(*args, **kwargs)
            seen.append({key: out[key].detach().clone() for key in (
                'z', 'mel_log_std', 'distill_mean', 'distill_log_std')
                if key in out})
            return out

        model.forward = keeping
        sides[name] = dict(
            model=model, optimizer=optimizer, em=em, generator=generator,
            paths=paths, seen=seen, steps=curriculum_step_fns(
                config, model, optimizer, em, stack_fn, recording,
                generator))
    kernels, plain = sides['kernels'], sides['plain']
    zero_counts()
    kernels['model'].data_dependent_init(batch['mels'], batch['mel_lengths'],
                                         step_fn=flow_step)
    launches = read_counts()
    first_decoder = [p.detach().clone()
                     for p in kernels['model'].layer_Dict['Decoder'
                                                          ].parameters()]
    names = [name for name, _ in kernels['model'].named_parameters()]
    for i, variant in enumerate(CURRICULUM):
        # the plain side starts the step from the kernels' side's state
        km, pm = kernels['model'], plain['model']
        pm.load_state_dict(km.state_dict())
        pm.layer_Dict['Decoder'].invalidate()
        plain['optimizer'].load_state_dict(
            kernels['optimizer'].state_dict(km), pm)
        plain['em'].stats = tuple(t.clone() for t in kernels['em'].stats)
        plain['generator'].set_state(kernels['generator'].get_state())
        out = {}
        for name, side in sides.items():
            decoder = [p.detach().clone() for p in
                       side['model'].layer_Dict['Decoder'].parameters()]
            zero_counts()
            metrics = side['steps'][variant](batch)
            counts = read_counts()
            grads = [torch.zeros_like(q) if q.grad is None
                     else q.grad.detach().clone()
                     for q in side['model'].parameters()]
            unchanged = all(torch.equal(p, q) for p, q in zip(
                side['model'].layer_Dict['Decoder'].parameters(), decoder))
            assert unchanged == variant[1], (name, i, unchanged)
            out[name] = ({key: value.item() for key, value in metrics.items()},
                         grads, counts, [t.clone() for t in side['em'].stats])
        (k, k_grads, k_counts, k_stats), (p, p_grads, _, p_stats) = (
            out['kernels'], out['plain'])
        scale = max(g.abs().max().item() for g in p_grads)
        diffs = sorted(((a - b).abs().max().item(), b.abs().max().item(),
                        name) for a, b, name in zip(k_grads, p_grads, names))
        grad_err = diffs[-1][0] / scale
        stats_err = max(rel_err(a, b) for a, b in zip(k_stats, p_stats))
        outputs = ', '.join(
            f'{key} {rel_err(kernels["seen"][i][key], value):.3e}'
            for key, value in plain['seen'][i].items())
        print(f'  step {i} {variant}: kernels ' + ' '.join(
            f'{key} {k[key]:.6f}' for key in sorted(k)) + '; plain '
            + ' '.join(f'{key} {p[key]:.6f}' for key in sorted(p))
            + f'; gradients {grad_err:.3e} of their max-abs (furthest: '
            f'{diffs[-1][2]}); em_stats {stats_err:.3e}; outputs {outputs}; '
            f'launches ' + json.dumps({key: v for key, v in k_counts.items()
                                       if v}))
        assert set(k) == set(p) and ('distill' in k) == (variant[0] == 'em')
        for key in k:
            bar = (TRAIN_NORM_REL_BOUND if key == 'grad_norm'
                   else TRAIN_LOSS_REL_BOUND)
            assert np.isfinite(k[key]), (i, key)
            assert abs(k[key] - p[key]) <= bar * abs(p[key]), (i, key, k, p)
        assert grad_err <= GRAD_REL_BOUND, (i, grad_err, diffs[-3:])
        assert stats_err <= EM_STATS_REL_BOUND, (i, stats_err)
        flows, mas = config.decoder.stack, {'em': 2, None: 1,
                                            'anchored': 1, 'linear': 0}
        assert k_counts == {
            **no_launches(), 'mas': mas[variant[0]],
            'train_fwd_c80': flows,
            'train_bwd_c80': BWD_KERNELS_PER_FLOW_STEP * flows}, k_counts
        for key, value in k_counts.items():
            launches[key] += value
        if i == 2:                       # the three frozen steps done
            optimizer = kernels['optimizer']
            frozen = {id(q) for q in km.layer_Dict['Decoder'].parameters()}
            unchanged = all(torch.equal(q, r) for q, r in zip(
                km.layer_Dict['Decoder'].parameters(), first_decoder))
            moved = all((mu.abs().max() > 0).item() and
                        (nu.abs().max() > 0).item() for q, mu, nu in
                        zip(optimizer.params, optimizer.mu, optimizer.nu)
                        if id(q) in frozen)
            print(f'  decoder bit-unchanged over the 3 frozen EM steps: '
                  f'{unchanged}; its moments (mu, nu) all moved: {moved}')
            assert unchanged and moved
    differing = sum((a != b).sum().item() for a, b in zip(kernels['paths'],
                                                          plain['paths']))
    frames = sum(a.shape[0] * a.shape[2] for a in plain['paths'])
    print(f'curriculum steps at MiniSpeech width {tuple(batch["mels"].shape)}'
          f': {len(plain["paths"])} MAS paths (2 an EM step, 1 a released or '
          f'anchored step, 0 a linear one), kernels vs plain: {differing} '
          f'differing elements ({frames} frames)')
    assert len(kernels['paths']) == len(plain['paths']) == 8
    assert differing == 0
    return launches


def time_curriculum_step(config, batch, state, device):
    """The EM step (decoder frozen) by events and its device work in a
    profiler window, beside a learned-prior MAS step at the same shape, and
    the peak memory of each."""
    from glow_tts_tpu_torch import make_optimizer
    from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
    from glow_tts_tpu_torch.ops.mas import maximum_path
    from glow_tts_tpu_torch.training.step import EMState, init_em_stats
    model = train_model(state, config, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'])
    optimizer = make_optimizer(config, model.parameters())
    steps = curriculum_step_fns(config, model, optimizer,
                                EMState(init_em_stats(config, device)),
                                flow_stack_train, maximum_path)
    em_step, plain_step = steps[('em', True)], steps[(None, False)]
    em_ms, plain_ms = paired_ms(lambda: em_step(batch),
                                lambda: plain_step(batch), iters=3)
    peaks = {}
    for name, fn in (('em', em_step), ('plain', plain_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn(batch)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() / 2 ** 30,
                       held / 2 ** 30)
    em_idle, em_busy = profile_window('MiniSpeech EM steps (decoder frozen)',
                                      lambda: em_step(batch), 2, warmup=1,
                                      busy=True)
    plain_idle, plain_busy = profile_window(
        'MiniSpeech learned-prior MAS steps', lambda: plain_step(batch), 2,
        warmup=1, busy=True)
    print(f'MiniSpeech step {tuple(batch["mels"].shape)}: EM step, decoder '
          f'frozen, {em_ms:.3f} ms by events ({em_busy:.3f} ms of device '
          f'work, device idle {100 * em_idle:.1f} %, peak '
          f'{peaks["em"][0]:.3f} GiB); learned-prior MAS step {plain_ms:.3f}'
          f' ms ({plain_busy:.3f} ms of device work, idle '
          f'{100 * plain_idle:.1f} %, peak {peaks["plain"][0]:.3f} GiB); '
          f'{peaks["em"][1]:.3f} GiB held before')
    return {'em_step_ms': em_ms, 'em_step_device_ms': em_busy,
            'em_step_idle': em_idle, 'em_step_peak_gib': peaks['em'][0],
            'mas_step_ms': plain_ms, 'mas_step_device_ms': plain_busy,
            'mas_step_idle': plain_idle,
            'mas_step_peak_gib': peaks['plain'][0]}


def run_minispeech_trainer(config, root, device):
    """A MiniSpeech ``Trainer`` with ``Alignment_Warmup_Steps`` =
    ``Decoder_Freeze_Steps`` = 2: run A 4 steps against run B (1 step, a
    new trainer restoring ``S_1.pt``, 3 more) across the release, bit for
    bit where the card allows and within ``RESUME_REL_BOUND`` by group,
    ``em_stats`` included; the evaluations and their free-running decodes
    on #3's 80-channel build; the launches by part."""
    from glow_tts_tpu_torch import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    write_minispeech_archive(os.path.join(root, 'train'), TRAIN_PATTERNS,
                             config, SEED + 93)
    write_minispeech_archive(os.path.join(root, 'eval'), EVAL_PATTERNS,
                             config, SEED + 94)

    def trainer(run, max_step, counts=None):
        # a checkpoint at the end of each run (run B's first at step 1)
        train = dataclasses.replace(
            config.train, max_step=max_step,
            checkpoint_save_interval=max_step,
            logging_interval=1, evaluation_interval=MS_TRAINER_STEPS,
            alignment_warmup_steps=MS_WARM_STEPS,
            decoder_freeze_steps=MS_WARM_STEPS)
        cfg = dataclasses.replace(
            config, train=train,
            checkpoint_path=os.path.join(root, run, 'checkpoint'),
            log_path=os.path.join(root, run, 'log'),
            inference_path=os.path.join(root, run, 'inference'))
        make = lambda: Trainer(  # noqa: E731
            cfg, device=device,
            writers={'train': MemoryWriter(), 'eval': MemoryWriter()})
        if counts is None:
            return make()
        made = counts.wrap('trainer init', make)()
        made.train_step = counts.wrap('trainer train', made.train_step)
        for key, fn in made.curriculum_steps.items():
            made.curriculum_steps[key] = counts.wrap('trainer train', fn)
        made.eval_step = counts.wrap('trainer eval', made.eval_step)
        made.model.inference_decode = counts.wrap(
            'trainer decode', made.model.inference_decode)
        return made

    counts = PartCounts()
    a = trainer('a', MS_TRAINER_STEPS, counts)
    # the variants the trainer builds, as the JAX trainer does; the run
    # takes (warmup, frozen) for its first 2 steps, then the plain step
    assert set(a.curriculum_steps) == {(True, True), (True, False),
                                       (False, True)}, a.curriculum_steps
    assert [a.step_function(step) for step in range(MS_TRAINER_STEPS)] == [
        a.curriculum_steps[(True, True)]] * MS_WARM_STEPS + [a.train_step] * (
            MS_TRAINER_STEPS - MS_WARM_STEPS)
    a.train()
    assert torch.isfinite(a.free_running['mels']).all(), 'free-running decode'
    trainer('b', MS_RESUME_STEP).train()
    b = trainer('b', MS_TRAINER_STEPS)
    assert b.step == MS_RESUME_STEP, b.step
    b.train()
    errs, equal = compare_runs(a, b, MS_RESUME_STEP)
    worst = max(value for value, _ in errs.values())
    logged = a.writers['train'].scalars
    assert [step for step, _ in logged['Loss/distill']] == [1, 2], logged
    print(f'MiniSpeech trainer, run A ({MS_TRAINER_STEPS} steps, EM warmup '
          f'and decoder freeze over the first {MS_WARM_STEPS}) against run B '
          f'({MS_RESUME_STEP} step, a new trainer restoring '
          f'S_{MS_RESUME_STEP}.pt, {MS_TRAINER_STEPS - MS_RESUME_STEP} '
          f'more, across the release): largest difference by group, '
          f'relative to its max-abs: ' + '; '.join(
              f'{group} {value:.3e} ({name})'
              for group, (value, name) in errs.items())
          + f'; bit-equal: {equal}; distill logged at steps '
          f'{[step for step, _ in logged["Loss/distill"]]}')
    assert worst <= RESUME_REL_BOUND and equal, errs
    flows = config.decoder.stack
    eval_batches = -(-EVAL_PATTERNS // config.train.batch_size)
    warm, released = MS_WARM_STEPS, MS_TRAINER_STEPS - MS_WARM_STEPS
    expected = {
        'trainer init': {'flow_step_c80': flows},
        'trainer train': {
            'mas': 2 * warm + released,
            'train_fwd_c80': flows * MS_TRAINER_STEPS,
            'train_bwd_c80': BWD_KERNELS_PER_FLOW_STEP * flows
            * MS_TRAINER_STEPS},
        'trainer eval': {'flow_step_c80': flows * eval_batches * 2,
                         'mas': eval_batches * 2},
        'trainer decode': {'flow_step_c80': flows * 2}}
    for part, want in expected.items():
        got = counts.by_part[part]
        print(f'  launches, MiniSpeech {part}: '
              + json.dumps({key: v for key, v in got.items() if v}))
        assert got == {**no_launches(), **want}, (part, got)
    return ({f'MiniSpeech {part}': value
             for part, value in counts.by_part.items()}, worst, equal)


def run_minispeech_phase(device, card):
    """The repo's converged recipe (``configs/MiniSpeech.yaml``: 80 flow
    channels at ``Num_Squeeze: 1``, the EM warmup and the decoder freeze)
    at its full width: each 80-channel build of #3, #2, #4, #5 and #6
    against its plain version to the shipped bars, timed; the curriculum's
    steps through the kernels and the plain versions; the EM step timed
    beside a learned-prior MAS step; an eval step under each route; and a
    ``Trainer`` resumed across the release.  Returns the kernels' rows and
    the launches by path."""
    import shutil
    import tempfile

    from glow_tts_tpu_torch import make_eval_step, random_state_dict
    from glow_tts_tpu_torch.models.layers import sequence_mask
    root = tempfile.mkdtemp(prefix='chip_smoke_minispeech_')
    clock, parts = time.perf_counter(), {}

    def lap(part):
        nonlocal clock
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[part] = round(now - clock, 1)
        clock = now

    try:
        config = minispeech_config(root)
        batch = minispeech_batch(config, device)
        state = random_state_dict(config, SEED + 95)   # live couplings
        model = fresh_model(state, config, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'])
        flow_err = check_kernel(model, device)
        coupling_err = check_coupling(model, device)
        stack_err = check_flow_stack(model, device)
        trainee = train_model(state, config, device)
        trainee.data_dependent_init(batch['mels'], batch['mel_lengths'])
        x, mask, weights = stack_problem(trainee, batch, config)
        del trainee
        fwd_err, fwd_one_pass = check_train_forward(x, mask, weights)
        bwd_err = check_train_backward(x, mask, weights)
        lap('kernels vs plain')

        by_path = {'MiniSpeech curriculum': run_curriculum_steps(
            config, batch, state, device)}
        lap('curriculum steps')
        # the deterministic decoder's other routes (#2's and #4's builds)
        # on the same weights: an eval step each, the losses held together
        losses = {}
        for route in ROUTES:
            routed = dataclasses.replace(config, coupling_backend=route)
            routed_model = fresh_model(model.state_dict(), routed, device)
            eval_step = make_eval_step(routed, routed_model)
            zero_counts()
            losses[route] = {key: value.item() for key, value in
                             eval_step(batch)[0].items()}
            by_path[f'MiniSpeech eval {route}'] = read_counts()
            assert by_path[f'MiniSpeech eval {route}'] == {
                **route_launches(route, routed), 'mas': 1}, route
        print('MiniSpeech eval step under each route: ' + json.dumps(losses))
        lap('eval under each route')
        for route in ('modules', 'mega'):
            for key in ('mle', 'duration'):
                a, b = losses[route][key], losses['fused'][key]
                assert abs(a - b) <= LOSS_REL_BOUND * abs(b), (route, key)

        eval_mask = sequence_mask(batch['mel_lengths'], batch['mels'].shape[1])
        flow_times, coupling_times, stack_times = time_flow_kernels(
            model, device, eval_mask, extras=False)
        lap('kernel timings')
        fwd_times, bwd_times = time_training(config, batch, x, mask, weights,
                                             device, extras=False)
        lap('train kernel timings')
        step_times = time_curriculum_step(config, batch, state, device)
        lap('step timings')
        del model, x, mask, weights
        trainer_paths, resume_err, resume_equal = run_minispeech_trainer(
            config, root, device)
        lap('trainer')
        by_path.update(trainer_paths)
        print('MiniSpeech: ' + json.dumps({
            **step_times, 'resume_max_rel_err': resume_err,
            'resume_bit_equal': resume_equal, 'seconds_by_part': parts,
            'card': card}))
        rows = {
            'flow_step': {'max_abs_err': flow_err[0],
                          'one_pass_max_rel_err': flow_err[1], **flow_times},
            'coupling': {'max_abs_err': coupling_err, **coupling_times},
            'flow_stack': {'max_abs_err': stack_err, **stack_times},
            'flow_train_fwd': {'max_abs_err': fwd_err,
                               'one_pass_max_rel_err': fwd_one_pass,
                               **fwd_times},
            'flow_train_bwd': {'max_abs_err': bwd_err, **bwd_times}}
        return rows, by_path
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# from wavs to wavs: the ETL, the reference-wav features and Griffin-Lim
# ---------------------------------------------------------------------------

WAV_UTTERANCES = 48            # MiniSpeech's corpus, made by its example
WAV_EVAL = 4                   # of them held out (the eval set)
WAV_TRAIN_STEPS = 6            # the Trainer's steps on the ETL's patterns
WAV_CHECKED = 4                # patterns held against the ETL on the CPU
WAV_EXPORTS = 4                # wavs the Inferencer exports, twice
DSP_MEL_BOUND = 2e-3           # card vs CPU mel, max-abs on the ±4 scale
NEAR_TIE = 1e-5                # a CMND this close to a YIN decision: the
                               # frame's pitch is not held (and counted)
GL_ONE_REL_BOUND = 1e-4        # Griffin-Lim card vs CPU, 1 iteration
GL_SC_REL_BOUND = 0.02         # and the spectral convergence after 60
GL_FRAMES = 1024               # the timed Griffin-Lim's mel
REF_MODES = ('SE-GE2E', 'PE', 'GR')
WAV_FLAC = 2                   # utterances also written and read as FLAC
FLAC_MEL_BOUND = 1e-4          # ETL mel from the FLAC vs from the WAV


def pitch_ties(audio, sound):
    """Frames of ``audio``'s YIN whose pitch a last-bit difference of the
    CMND can move (the CPU's CMND within ``NEAR_TIE`` of the threshold, or
    of the next lag on the walk to the dip)."""
    from glow_tts_tpu_torch.ops import yin
    tau_min = int(sound.sample_rate / sound.pitch_max)
    tau_max = int(sound.sample_rate / sound.pitch_min)
    cmnd = yin.yin_cmnd(torch.as_tensor(yin.pad_for_yin(
        audio, sound.frame_length, sound.frame_shift)), sound.frame_length,
        sound.frame_shift, tau_max).double().numpy()
    thresh = 1.0 - sound.confidence_threshold
    in_range = np.arange(tau_max) >= tau_min
    below = (cmnd < thresh) & in_range
    first = np.where(below.any(1), below.argmax(1), tau_max)
    on_walk = np.arange(tau_max - 1)[None] >= first[:, None]
    step = np.abs(np.diff(cmnd, axis=1))     # equal lags (silence) tie alike
    return (((np.abs(cmnd - thresh) < NEAR_TIE) & in_range).any(1)
            | ((0 < step) & (step < NEAR_TIE) & on_walk).any(1))


def hold_features(card, cpu, audios, sound, what, device):
    """Card features against the CPU's: the mels of ``card`` and ``cpu``
    within ``DSP_MEL_BOUND``, and the raw YIN of each of ``audios`` on the
    card equal to the CPU's outside its near-tie frames (raw, so that a
    tie cannot move the normalisation).  Returns (worst mel error,
    near-tie frames, pitch frames)."""
    from glow_tts_tpu_torch.ops import yin
    worst, ties, frames = 0.0, 0, 0
    for key in card:
        if key.startswith('mel'):
            assert card[key].shape == cpu[key].shape, (what, key)
            worst = max(worst, float(np.abs(card[key] - cpu[key]).max()))
    for audio in audios:
        kwargs = dict(w_len=sound.frame_length, w_step=sound.frame_shift,
                      f0_min=sound.pitch_min, f0_max=sound.pitch_max,
                      confidence_threshold=sound.confidence_threshold)
        got = yin.pitch_calc(audio, sound.sample_rate, device=device,
                             **kwargs)
        want = yin.pitch_calc(audio, sound.sample_rate, device='cpu',
                              **kwargs)
        tie = pitch_ties(audio, sound)
        assert got.shape == want.shape == tie.shape, what
        assert np.array_equal(got[~tie], want[~tie]), (what, np.flatnonzero(
            got != want))
        ties, frames = ties + int(tie.sum()), frames + tie.size
    assert worst <= DSP_MEL_BOUND, (what, worst)
    assert ties <= 0.05 * max(frames, 20), (what, ties, frames)
    return worst, ties, frames


def spectral_convergence(audio, magnitude, sound):
    """||M - |STFT(y)||| / ||M||, in float64 on the CPU."""
    from glow_tts_tpu_torch.ops import vocoder
    n_fft = (sound.spectrogram_dim - 1) * 2
    rebuilt = vocoder._stft_complex(
        torch.as_tensor(audio, dtype=torch.float64), n_fft,
        sound.frame_shift, sound.frame_length).abs()[:magnitude.shape[0]]
    target = torch.as_tensor(magnitude, dtype=torch.float64)
    return float(torch.linalg.norm(target - rebuilt)
                 / torch.linalg.norm(target))


def check_griffin_lim(mel, sound, device):
    """Griffin-Lim on the card against the CPU from the same start phase:
    within ``GL_ONE_REL_BOUND`` after one iteration; after 60, their
    spectral convergences within ``GL_SC_REL_BOUND`` of each other."""
    from glow_tts_tpu_torch.ops import vocoder
    n_fft = (sound.spectrogram_dim - 1) * 2
    magnitude = vocoder.mel_to_magnitude(
        torch.as_tensor(mel), sound.sample_rate, sound.spectrogram_dim,
        sound.mel_dim, sound.mel_f_min, sound.mel_f_max,
        max_abs_value=sound.max_abs_mel)
    angles = vocoder.start_angles(magnitude.shape)
    out = {}
    for iterations in (1, 60):
        waves = [vocoder.griffin_lim(
            magnitude.to(where), n_fft, sound.frame_shift, sound.frame_length,
            iterations=iterations, angles=angles).cpu().numpy()
            for where in (device, 'cpu')]
        if iterations == 1:
            out['one_iteration_rel_err'] = float(
                np.abs(waves[0] - waves[1]).max() / np.abs(waves[1]).max())
        else:
            card, cpu = (spectral_convergence(w, magnitude, sound)
                         for w in waves)
            out.update(sc_card=card, sc_cpu=cpu)
    print(f'Griffin-Lim, card against CPU from the same start phase '
          f'({mel.shape[0]} frames): after 1 iteration '
          f'{out["one_iteration_rel_err"]:.3e} of max-abs (bar '
          f'{GL_ONE_REL_BOUND}); spectral convergence after 60: card '
          f'{out["sc_card"]:.6f}, CPU {out["sc_cpu"]:.6f} (bar '
          f'{GL_SC_REL_BOUND} relative)')
    assert out['one_iteration_rel_err'] <= GL_ONE_REL_BOUND, out
    assert (abs(out['sc_card'] - out['sc_cpu'])
            <= GL_SC_REL_BOUND * out['sc_cpu']), out
    return out


def time_dsp(audio, mel, sound, device):
    """Device ms, by events after warm-up: the mel and the YIN of
    ``audio`` per second of it, and Griffin-Lim's 60 iterations on a
    ``GL_FRAMES``-frame mel (``mel`` tiled)."""
    from glow_tts_tpu_torch.ops import stft, vocoder, yin
    seconds = audio.shape[0] / sound.sample_rate
    wave = torch.as_tensor(audio, device=device)
    padded = torch.as_tensor(yin.pad_for_yin(
        audio, sound.frame_length, sound.frame_shift), device=device)
    mel_ms = cuda_ms(lambda: stft.mel_spectrogram(
        wave, sound.sample_rate, sound.spectrogram_dim, sound.mel_dim,
        sound.frame_length, sound.frame_shift, mel_fmin=sound.mel_f_min,
        mel_fmax=sound.mel_f_max, max_abs_value=sound.max_abs_mel), 20)
    yin_ms = cuda_ms(lambda: yin.compute_yin_frames(
        padded, sound.sample_rate, sound.frame_length, sound.frame_shift,
        sound.pitch_min, sound.pitch_max,
        1.0 - sound.confidence_threshold), 20)
    long_mel = np.tile(mel, (-(-GL_FRAMES // mel.shape[0]), 1))[:GL_FRAMES]
    magnitude = vocoder.mel_to_magnitude(
        torch.as_tensor(long_mel, device=device), sound.sample_rate,
        sound.spectrogram_dim, sound.mel_dim, sound.mel_f_min,
        sound.mel_f_max, max_abs_value=sound.max_abs_mel)
    angles = vocoder.start_angles(magnitude.shape, device)
    n_fft = (sound.spectrogram_dim - 1) * 2
    gl_ms = cuda_ms(lambda: vocoder.griffin_lim(
        magnitude, n_fft, sound.frame_shift, sound.frame_length,
        angles=angles), 3, warmup=1)
    return {'mel_ms_per_audio_sec': mel_ms / seconds,
            'yin_ms_per_audio_sec': yin_ms / seconds,
            'dsp_audio_sec': seconds,
            'griffin_lim_60_ms_1024_frames': gl_ms}


def wav_trainer(config, device):
    """The MiniSpeech ``Trainer`` on the ETL's patterns for
    ``WAV_TRAIN_STEPS`` steps (all in the EM warmup with the decoder
    frozen), evaluating before and after, a checkpoint at the end; its
    launches by part."""
    from glow_tts_tpu_torch import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    train = dataclasses.replace(
        config.train, checkpoint_save_interval=WAV_TRAIN_STEPS,
        logging_interval=WAV_TRAIN_STEPS // 2,
        evaluation_interval=WAV_TRAIN_STEPS)
    config = dataclasses.replace(config, train=train)
    counts = PartCounts()
    trainer = counts.wrap('wavs trainer init', lambda: Trainer(
        config, device=device,
        writers={'train': MemoryWriter(), 'eval': MemoryWriter()}))()
    assert set(trainer.curriculum_steps) == {(True, True), (True, False),
                                             (False, True)}
    for key, fn in trainer.curriculum_steps.items():
        trainer.curriculum_steps[key] = counts.wrap('wavs trainer train', fn)
    trainer.eval_step = counts.wrap('wavs trainer eval', trainer.eval_step)
    trainer.model.inference_decode = counts.wrap(
        'wavs trainer decode', trainer.model.inference_decode)
    start = time.perf_counter()
    trainer.train()
    seconds = time.perf_counter() - start
    assert trainer.checkpoints.steps() == [WAV_TRAIN_STEPS]
    logged = trainer.writers['train'].scalars
    assert all(np.isfinite(v) for _, v in logged['Loss/total']), logged
    evals = trainer.writers['eval'].scalars
    flows, steps = config.decoder.stack, WAV_TRAIN_STEPS
    eval_batches = -(-len(trainer.eval_dataset) // config.train.batch_size)
    expected = {
        'wavs trainer init': {'flow_step_c80': flows},
        'wavs trainer train': {
            'mas': 2 * steps, 'train_fwd_c80': flows * steps,
            'train_bwd_c80': BWD_KERNELS_PER_FLOW_STEP * flows * steps},
        'wavs trainer eval': {'flow_step_c80': flows * eval_batches * 2,
                              'mas': eval_batches * 2},
        'wavs trainer decode': {'flow_step_c80': flows * 2}}
    for part, want in expected.items():
        got = counts.by_part[part]
        print(f'  launches, {part}: '
              + json.dumps({key: v for key, v in got.items() if v}))
        assert got == {**no_launches(), **want}, (part, got)
    print(f'MiniSpeech Trainer on the ETL\'s patterns: {steps} EM steps '
          f'with the decoder frozen in {seconds:.1f} s (the evaluations and '
          f'the checkpoint included); loss '
          f'{[round(v, 4) for _, v in logged["Loss/total"]]}; eval mle '
          f'{[round(v, 4) for _, v in evals["Loss/mle"]]}')
    del trainer
    return counts.by_part, seconds


def export_wavs(config, device, items, root):
    """The trained checkpoint served through ``Inferencer`` with the wav
    export, twice: the wavs read back with the port's ``audio_io`` are
    ``hop · (frames − 1)`` samples, finite, of peak 1, and the second
    export's files are the first's bit for bit.  The first export warms
    the vocoder up (cuFFT plans for each length); the second is timed.
    Returns the launches, the real-time factors and the first result's
    mel."""
    from glow_tts_tpu_torch import Inferencer
    from glow_tts_tpu_torch.data.audio_io import load_audio
    inferencer = Inferencer(config.checkpoint_path, config, device,
                            max_mel_length=1024)
    inferencer.synthesize_items(items)               # warm-up
    start = time.perf_counter()
    inferencer.synthesize_items(items)
    mel_wall = time.perf_counter() - start
    results = inferencer.synthesize_items(
        items, out_dir=os.path.join(root, 'export_a'), export_wav=True)
    zero_counts()
    start = time.perf_counter()
    again = inferencer.synthesize_items(
        items, out_dir=os.path.join(root, 'export_b'), export_wav=True)
    full_wall = time.perf_counter() - start
    launches = read_counts()
    assert launches == route_launches('fused', config), launches
    sound = config.sound
    for result, repeat in zip(results, again):
        name = os.path.join('WAV', f'{result["label"]}.wav')
        with open(os.path.join(root, 'export_a', name), 'rb') as f:
            first = f.read()
        with open(os.path.join(root, 'export_b', name), 'rb') as f:
            assert f.read() == first, name
        audio = load_audio(os.path.join(root, 'export_a', name),
                           sound.sample_rate)
        frames = result['mel'].shape[0]
        assert audio.shape == (sound.frame_shift * (frames - 1),), (
            name, audio.shape, frames)
        assert np.isfinite(audio).all() and np.abs(audio).max() == 1.0, name
        assert np.array_equal(result['audio'], repeat['audio']), name
    audio_sec = (sum(r['mel'].shape[0] for r in results) * sound.frame_shift
                 / sound.sample_rate)
    times = {'rtf_mel': mel_wall / audio_sec,
             'rtf_total_with_vocoder_export': full_wall / audio_sec,
             'export_audio_sec': audio_sec}
    print(f'export: {len(results)} wavs (frames '
          f'{[r["mel"].shape[0] for r in results]}), read back: '
          f'hop x (frames - 1) samples, finite, peak 1; a second export '
          f'bit-equal; ' + json.dumps(times) + f'; launches {launches}')
    return launches, times, results[0]['mel']


def serve_from_reference_wavs(wavs, device):
    """SE-GE2E, PE and GR at the shipped width (random weights from a
    seed) served from features made on the card of ``wavs`` (their
    ``wav_for_*``), held against the same features made on the CPU; GR
    through #3's pitch build."""
    from glow_tts_tpu_torch import Inferencer, random_state_dict
    from glow_tts_tpu_torch.data.pattern_generator import (
        audio_prep, load_reference_features)
    from glow_tts_tpu_torch.text import text_filtering
    by_path, held = {}, {}
    for mode in REF_MODES:
        config = mode_config(mode)
        inferencer = Inferencer(random_state_dict(config, SEED), config,
                                device, batch_size=WAV_EXPORTS)
        items = [{'label': f'r{i}', 'text': text_filtering(text),
                  'speaker_id': i, 'wav_for_ge2e': wavs[i],
                  'wav_for_prosody': wavs[i + 1],
                  'wav_for_pitch': wavs[i + 2]}
                 for i, text in enumerate(INFERENCE_TEXTS[:WAV_EXPORTS])]
        card = [inferencer.with_features(item) for item in items]
        cpu = [load_reference_features(config, item, 'cpu')
               for item in items]
        worst, ties, frames = 0.0, 0, 0
        for i, (a, b) in enumerate(zip(card, cpu)):
            keys = {key: a[key] for key in ('mel_for_ge2e', 'mel_for_prosody')
                    if key in a}
            audios = ([audio_prep(items[i]['wav_for_pitch'],
                                  config.sound.sample_rate, 30)]
                      if 'pitch' in a else [])
            err, tie, n = hold_features(keys, b, audios, config.sound, mode,
                                        device)
            if 'pitch' in a and not tie:
                assert np.array_equal(a['pitch'], b['pitch']), mode
            worst, ties, frames = max(worst, err), ties + tie, frames + n
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        assert launches == route_launches(
            'fused', config, pitch=mode == 'GR'), (mode, launches)
        for r in results:
            assert np.isfinite(r['mel']).all() and r['mel'].shape[0] > 0
        held[mode] = {'mel_max_abs_err': worst, 'pitch_near_tie_frames': ties,
                      'pitch_frames': frames}
        print(f'{mode} from reference wavs (features made on the card, '
              f'held against the CPU\'s, trimmed at 30 dB): '
              f'{json.dumps(held[mode])}; served {len(results)} requests, '
              f'mel frames {[r["mel"].shape[0] for r in results]}, launches '
              f'{launches}')
        by_path[f'serve {mode} from wavs'] = launches
        del inferencer
    return by_path, held


def check_flac(config, wavs, root, device):
    """``wavs`` written as FLAC by the port's encoder (``data/flac.py``):
    the native decoder (``data/flac_native.py``, built at first use) and
    the pure codec bit-equal and lossless; the ETL's mels of each FLAC file
    (``pattern_generate``: soundfile where it imports, else the native
    decoder) against those of its WAV, within ``FLAC_MEL_BOUND``; each
    decoder's host ms per second of audio (the native library built or
    loaded first, apart)."""
    from scipy.io import wavfile

    from glow_tts_tpu_torch.data import flac, flac_native
    from glow_tts_tpu_torch.data.pattern_generator import (TOP_DB,
                                                           pattern_generate)
    start = time.perf_counter()
    flac_native._load_library()          # built at first use: not timed
    build_sec = time.perf_counter() - start
    seconds, host, worst = 0.0, {'native': 0.0, 'pure': 0.0}, 0.0
    for wav in wavs:
        rate, samples = wavfile.read(wav)
        assert samples.dtype == np.int16, samples.dtype
        path = os.path.join(root, os.path.basename(wav)[:-4] + '.flac')
        flac.write(path, samples, rate)
        seconds += len(samples) / rate
        decoded = {}
        for name, read in (('native', flac_native.read),
                           ('pure', flac.read)):
            start = time.perf_counter()
            decoded[name] = read(path)[0]
            host[name] += time.perf_counter() - start
        assert np.array_equal(decoded['native'], decoded['pure']), wav
        assert np.array_equal(decoded['native'] * 32768.0,
                              samples.astype(np.float32)), wav
        mels = [pattern_generate(config, source, TOP_DB['LJ'], device)[1]
                for source in (path, wav)]
        assert mels[0].shape == mels[1].shape, (wav, mels[0].shape,
                                                mels[1].shape)
        worst = max(worst, float(np.abs(mels[0] - mels[1]).max()))
    row = {'utterances': len(wavs), 'audio_sec': seconds,
           'native_build_or_load_sec': build_sec,
           'etl_decoder': ('soundfile' if importable('soundfile')
                           else 'native'),
           'native_vs_pure': 'bit-equal', 'mel_max_abs_err_vs_wav': worst,
           'native_host_ms_per_audio_sec': 1e3 * host['native'] / seconds,
           'pure_host_ms_per_audio_sec': 1e3 * host['pure'] / seconds,
           'library': os.path.relpath(flac_native.library_path(),
                                      os.path.dirname(
                                          os.path.abspath(__file__)))}
    print('FLAC: ' + json.dumps(row))
    assert worst <= FLAC_MEL_BOUND, row
    return row


def run_wav_phase(device, card):
    """From wavs to wavs (``ROADMAP.md`` A.6): MiniSpeech's corpus
    (``examples/make_minispeech.py``, a subprocess) through the port's ETL
    on the card, held against the same ETL on the CPU; the recipe's
    ``Trainer`` on those patterns (#1, #5, #6 at 80 channels), its
    checkpoint served through ``Inferencer`` with the Griffin-Lim export;
    Griffin-Lim on the card against the CPU; SE-GE2E, PE and GR served at
    the shipped width from reference-wav features made on the card; the
    DSP timed.  Returns the launches by path."""
    import random
    import shutil
    import tempfile

    from glow_tts_tpu_torch.data.pattern_generator import (
        TOP_DB, generate_patterns, pattern_generate)
    from glow_tts_tpu_torch.tools import minispeech_e2e as e2e
    root = tempfile.mkdtemp(prefix='chip_smoke_wavs_')
    try:
        start = time.perf_counter()
        corpus = os.path.join(root, 'corpus')
        e2e.make_corpus(corpus, WAV_UTTERANCES, SEED)
        corpus_sec = time.perf_counter() - start
        config = dataclasses.replace(
            e2e.minispeech_config(root, WAV_TRAIN_STEPS),
            compute_dtype='float32')
        random.seed(SEED)
        torch.cuda.synchronize()
        start = time.perf_counter()
        generate_patterns(config, {'LJ': corpus}, use_text=True,
                          eval_ratio=WAV_EVAL / WAV_UTTERANCES,
                          eval_min=WAV_EVAL, device=device)
        etl_sec = time.perf_counter() - start
        files = {split: e2e.pattern_files(path) for split, path in (
            ('train', config.train.train_pattern.path),
            ('eval', config.train.eval_pattern.path))}
        assert (len(files['train']), len(files['eval'])) == (
            WAV_UTTERANCES - WAV_EVAL, WAV_EVAL), files
        # the same ETL on the CPU, for a few of the utterances
        import pickle
        worst, ties, frames = 0.0, 0, 0
        wavs = sorted(os.path.join(corpus, 'wavs', name)
                      for name in os.listdir(os.path.join(corpus, 'wavs')))
        for wav in wavs[:WAV_CHECKED]:
            stem = os.path.splitext(os.path.basename(wav))[0].upper()
            path, = [f for split in files.values() for f in split
                     if os.path.basename(f) == f'LJ.{stem}.PICKLE']
            with open(path, 'rb') as f:
                pattern = pickle.load(f)
            audio, mel, pitch = pattern_generate(config, wav, TOP_DB['LJ'],
                                                 'cpu')
            assert np.array_equal(audio, pattern['Audio']), wav
            err, tie, n = hold_features({'mel': pattern['Mel']},
                                        {'mel': mel}, [audio], config.sound,
                                        wav, device)
            if not tie:
                assert np.array_equal(pattern['Pitch'], pitch), wav
            worst, ties, frames = max(worst, err), ties + tie, frames + n
        etl = {'utterances': WAV_UTTERANCES, 'corpus_sec': corpus_sec,
               'etl_sec': etl_sec,
               'etl_ms_per_utterance': 1e3 * etl_sec / WAV_UTTERANCES,
               'mel_max_abs_err_vs_cpu': worst, 'pitch_near_tie_frames': ties,
               'pitch_frames_checked': frames}
        print('ETL on the card: ' + json.dumps(etl))
        etl['flac'] = check_flac(config, wavs[:WAV_FLAC], root, device)

        by_path, train_sec = wav_trainer(config, device)
        items = e2e.eval_texts(config.train.eval_pattern.path, WAV_EXPORTS)
        launches, export_times, mel = export_wavs(config, device, items,
                                                  root)
        by_path['wavs export'] = launches
        with open(files['train'][0], 'rb') as f:
            pattern = pickle.load(f)
        gl = check_griffin_lim(pattern['Mel'], config.sound, device)
        served, held = serve_from_reference_wavs(wavs, device)
        by_path.update(served)
        times = time_dsp(pattern['Audio'], pattern['Mel'], config.sound,
                         device)
        print('wavs: ' + json.dumps({
            **etl, 'train_sec': train_sec, **export_times, **gl,
            'reference_features': held, **times, 'card': card}))
        return by_path
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# ROADMAP C.5: the f32 encoder under PyTorch's default flags
# ---------------------------------------------------------------------------

F32_ITEMS = 4                  # eval items held against the CPU
F32_TIMED = 5                  # calls a timing takes, after one warm-up
F32_ROUNDS = 3                 # rounds of the three ways, in turn


@contextlib.contextmanager
def tf32_flags(cudnn, matmul=False):
    """cuDNN's and the matmuls' TF32 flags for the block, the caller's
    back after it (PyTorch's defaults: ``cudnn`` True, ``matmul``
    False)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def conv1d_forward(kind):
    """``Conv1d``'s float32 k-tap forward, for the block, another way than
    the shipped ``conv_float32``: ``'library'``, the library's
    ``F.conv1d`` with autograd's backward, both as the flags say (the port
    before the repair of ROADMAP C.5), or ``'taps'``, k float32 products
    (``ops.coupling.tap_conv``, the other repair measured)."""
    import torch.nn.functional as F

    from glow_tts_tpu_torch.models.layers import Conv1d
    from glow_tts_tpu_torch.ops.coupling import tap_conv
    shipped = Conv1d.forward

    def other(self, x):
        k = self.weight.shape[-1]
        if (self.dtype != torch.float32 or k == 1
                or self.reduce_over is not None):
            return shipped(self, x)
        if kind == 'taps':
            return tap_conv(x, self.weight.permute(2, 1, 0)) + self.bias
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                        padding=(k - 1) // 2).transpose(1, 2)
    Conv1d.forward = other
    try:
        yield
    finally:
        Conv1d.forward = shipped


def library_modules_under_default_flags(config, device):
    """cuDNN's own float32 LSTM (GE2E's widths), GRU (the GST's) and
    Conv2d (a conv of the GST's stack) under PyTorch's default flags and
    with cuDNN's TF32 off, and the port's ways under the default flags
    (the LSTM in ``cudnn_float32``, the written-out GRU, ``conv_float32``),
    each against the same module on the CPU (max error over max-abs); the
    LSTM's time in ``cudnn_float32`` beside its written-out steps."""
    from torch import nn

    from glow_tts_tpu_torch.models.conditioning import (
        GSTProsodyEncoder, gru_steps, lstm_steps)
    from glow_tts_tpu_torch.ops.precision import conv_float32, cudnn_float32

    def scoped_lstm(m, x):
        with cudnn_float32():
            return m(x)[0]
    gen = torch.Generator().manual_seed(SEED + 40)
    ge2e = config.speaker_embedding.ge2e
    gst = GSTProsodyEncoder(config).layer_Dict
    gru, conv = gst['GRU'], gst['Conv_1'].Conv
    cases = {
        'lstm': (nn.LSTM(config.sound.mel_dim, ge2e.lstm.sizes,
                         ge2e.lstm.stacks, batch_first=True),
                 (8, ge2e.inference.slice_length, config.sound.mel_dim),
                 lambda m, x: m(x)[0], scoped_lstm),
        'gru': (gru, (8, 64, gru.input_size), lambda m, x: m(x)[0],
                lambda m, x: gru_steps(m, x, torch.float32)),
        'conv2d': (conv, (8, conv.in_channels, 40, 500), lambda m, x: m(x),
                   lambda m, x: conv_float32(x, m.weight, None, m.stride,
                                             m.padding))}
    out = {}
    for name, (module, shape, library, port) in cases.items():
        x = torch.randn(shape, generator=gen)
        with torch.no_grad():
            want = library(module, x)
            module = module.to(device)
            xd = x.to(device)
            with tf32_flags(cudnn=True):
                out[f'{name}_cudnn_default_flags'] = rel_err(
                    library(module, xd).cpu(), want)
                out[f'{name}_port_default_flags'] = rel_err(
                    port(module, xd).cpu(), want)
                if name == 'lstm':
                    out['lstm_cudnn_float32_ms'] = cuda_ms(
                        lambda: port(module, xd), F32_TIMED, warmup=1)
                    out['lstm_written_out_ms'] = cuda_ms(
                        lambda: lstm_steps(module, xd, torch.float32),
                        F32_TIMED, warmup=1)
            with tf32_flags(cudnn=False):
                out[f'{name}_cudnn_tf32_off'] = rel_err(
                    library(module, xd).cpu(), want)
    return out


def run_f32_default_flags_phase(state, config, batches, device, card):
    """ROADMAP C.5 under PyTorch's default flags (cuDNN's TF32 on, the
    matmuls' off), restored around each reading: the f32 prior phase on
    the eval batch's tokens (B = 32) and one f32 eval step on its first
    ``F32_ITEMS`` items (224 tokens × 1024 frames) at the shipped widths,
    held against the port on the CPU at 1e-4 of max-abs (mean, log std and
    log-durations of both, the eval's z; the losses to
    ``LOSS_REL_BOUND``); the same reading through the library's
    ``F.conv1d`` shown past that bar; cuDNN's LSTM, GRU and Conv2d under
    those flags; the f32 train step (B = 32) and the prior phase timed by
    CUDA events three ways, ``F32_ROUNDS`` rounds in turn: the shipped
    ``conv_float32`` (cuDNN in float32, forward and backward), k float32
    products a conv (``tap_conv``, the other repair) and the library conv
    under the default flags (the port before the repair)."""
    from glow_tts_tpu_torch import (make_eval_step, make_optimizer,
                                    make_train_step)
    full = batches[0]
    batch = {key: value[:F32_ITEMS] for key, value in full.items()}
    cpu = {'model': fresh_model(state, config, 'cpu'),
           'batch': {key: value.cpu() for key, value in batch.items()},
           'full': {key: value.cpu() for key, value in full.items()}}
    model = fresh_model(state, config, device)

    def reading(m, b, prior_batch):
        prior = m.inference_prior(prior_batch['tokens'],
                                  prior_batch['token_lengths'])
        losses, out = make_eval_step(config, m)(b)
        tensors = {f'prior {key}': prior[key].float()
                   for key in ('mean', 'log_std', 'log_durations')}
        tensors.update({'eval z': out['z'],
                        'eval log_durations': out['log_durations'].float()})
        return tensors, {key: losses[key].item()
                         for key in ('mle', 'duration')}

    ref, ref_losses = reading(cpu['model'], cpu['batch'], cpu['full'])

    def errors():
        got, losses = reading(model, batch, full)
        row = {key: rel_err(got[key].cpu(), ref[key]) for key in ref}
        row.update({f'{key} loss': abs(losses[key] - want) / abs(want)
                    for key, want in ref_losses.items()})
        return row

    with tf32_flags(cudnn=True):
        shipped = errors()
        with conv1d_forward('library'):
            before = errors()
    tensors = [key for key in ref]
    losses = [f'{key} loss' for key in ref_losses]
    print('f32 under the default flags (cuDNN TF32 on), against the CPU, '
          'max err / max-abs: shipped conv_float32 ' + ', '.join(
              f'{key} {shipped[key]:.2e}' for key in tensors + losses)
          + f' (bars {Z_REL_BOUND}, losses {LOSS_REL_BOUND}: held); the '
          'library conv1d ' + ', '.join(
              f'{key} {before[key]:.2e}' for key in tensors + losses)
          + ' (past the bar: the reading bites)')
    assert max(shipped[key] for key in tensors) <= Z_REL_BOUND, shipped
    assert max(shipped[key] for key in losses) <= LOSS_REL_BOUND, shipped
    encoder = [key for key in tensors if key != 'eval z']
    assert max(before[key] for key in encoder) > Z_REL_BOUND, before
    modules = library_modules_under_default_flags(config, device)
    print('cuDNN float32 modules under the default flags vs CPU, max err / '
          'max-abs: ' + json.dumps(modules))

    trainee = train_model(state, config, device)
    trainee.data_dependent_init(full['mels'], full['mel_lengths'])
    step = make_train_step(
        config, trainee, make_optimizer(config, trainee.parameters()),
        seed=SEED, generator=torch.Generator(device=device).manual_seed(SEED))
    ways = {'conv_float32': contextlib.nullcontext,
            'taps': functools.partial(conv1d_forward, 'taps'),
            'library_tf32': functools.partial(conv1d_forward, 'library')}
    times = {way: {'train_step_ms': [], 'prior_ms': []} for way in ways}
    with tf32_flags(cudnn=True):
        for _ in range(F32_ROUNDS):
            for way, scope in ways.items():
                with scope():
                    times[way]['train_step_ms'].append(cuda_ms(
                        lambda: step(full), F32_TIMED, warmup=1))
                    times[way]['prior_ms'].append(cuda_ms(
                        lambda: model.inference_prior(
                            full['tokens'], full['token_lengths']),
                        F32_TIMED * 4, warmup=1))
    medians = {way: {key: float(np.median(values))
                     for key, values in row.items()}
               for way, row in times.items()}
    print('f32 under the default flags, median of '
          f'{F32_ROUNDS} rounds by CUDA events ({card}): ' + '; '.join(
              f'{way}: train step {m["train_step_ms"]:.2f} ms, prior '
              f'{m["prior_ms"]:.2f} ms' for way, m in medians.items()))
    row = {'shipped': shipped, 'library_conv1d': before, **modules,
           'times': times, 'medians': medians,
           'batch': list(full['mels'].shape),
           'tokens': list(full['tokens'].shape), 'card': card}
    print('f32 default flags: ' + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# bfloat16: the shipped YAMLs as shipped (TPU.compute_dtype bfloat16), the
# bfloat16 builds of #3, #5 and #6
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# kernel at bf16 against its bf16 plain version, the f32 plain version the
# reference: max|kernel - plain_bf16| <= 2 max|plain_bf16 - plain_f32| +
# 1e-6; gradients within 3e-2 norm-relative of the f32 plain version's and
# at most twice the bf16 plain version's distance from them, plus 1e-4
BF16_FACTOR, BF16_ATOL = 2.0, 1e-6
BF16_GRAD_F32_BAR, BF16_GRAD_FACTOR, BF16_GRAD_ATOL = 3e-2, 2.0, 1e-4
PEAK_BF16_FLOP_PER_S = 989e12   # dense, the tensor cores
BF16_EVAL_STEPS = 2
MS_BF16_TRAINER_STEPS = 3


def bf16_error(kernel, plain16, plain32):
    """(max|kernel - plain_bf16|, the bar 2 max|plain_bf16 - plain_f32| +
    1e-6), every tensor as float32."""
    kernel, plain16, plain32 = (v.float() for v in (kernel, plain16,
                                                    plain32))
    return ((kernel - plain16).abs().max().item(),
            BF16_FACTOR * (plain16 - plain32).abs().max().item() + BF16_ATOL)


def norm_rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def bf16_bounds(moved, flops):
    """A bfloat16 body's bounds: the larger of its operations at the bf16
    dense peak of the tensor cores and its bytes at the memory rate, and
    each of the two."""
    ms, by = bound(moved, flops, PEAK_BF16_FLOP_PER_S)
    return {'bound_ms': ms, 'bound_by': by,
            'ops_bound_ms': flops / PEAK_BF16_FLOP_PER_S * 1e3,
            'bytes_bound_ms': moved / PEAK_BYTES_PER_S * 1e3}


def check_bf16_step(model, device, label, pitch=False):
    """#3's bf16 build against its bf16 plain version with the f32 plain
    version as the reference, on check_kernel's shapes (B = 32, T = 512 and
    333, ragged, both directions); with ``pitch`` the pitch build (GR
    mode's weights and a pitch operand).  Beside each, the bf16 kernel's
    distance from the f32 kernel and the bf16 plain version's from the f32
    plain version.  Returns the worst max-abs error against the bf16 plain
    version."""
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    gen = torch.Generator().manual_seed(SEED + 101)
    worst = 0.0
    for t in (512, 333):
        x, mask = ragged_batch(gen, 32, t, c, device)
        x16 = x.to(BF16)
        cond = step.cond(32)
        p = (torch.rand((32, t, model.config.decoder.num_squeeze),
                        generator=gen).to(device) * mask if pitch else None)
        for reverse in (False, True):
            w32, w16 = step.weights(reverse), step.weights(reverse, BF16)
            k16 = flow_step(x16, mask, w16, cond, reverse, pitch=p)
            k32 = flow_step(x16.float(), mask, w32, cond, reverse, pitch=p)
            p16 = flow_step_reference(x16, mask, w32, cond, reverse, p)
            p32 = flow_step_reference(x16.float(), mask, w32, cond, reverse,
                                      p)
            torch.cuda.synchronize()
            assert k16[0].dtype == BF16 and torch.isfinite(
                k16[0].float()).all()
            err, bar = bf16_error(k16[0], p16[0], p32[0])
            line = (f'#3 bf16 {label} T={t} reverse={reverse}: kernel vs '
                    f'bf16 plain max abs err {err:.3e} (bar {bar:.3e}); '
                    f'bf16 kernel vs f32 kernel '
                    f'{(k16[0].float() - k32[0]).abs().max().item():.3e}, '
                    f'bf16 plain vs f32 plain '
                    f'{(p16[0].float() - p32[0]).abs().max().item():.3e}')
            if not reverse:
                ld_err, ld_bar = bf16_error(k16[1], p16[1], p32[1])
                line += f'; logdet {ld_err:.3e} (bar {ld_bar:.3e})'
                assert ld_err <= ld_bar, line
            print(line)
            assert err <= bar, line
            worst = max(worst, err)
    return worst


def check_bf16_train(x, mask, weights, label, cond=None, pitch=None):
    """#5 and #6's bf16 builds against the bf16 plain version, the f32
    plain version the reference: z and the logdet at rate 0.05 and 0, the
    dropout masks element by element (the probe of check_train_forward,
    through the bf16 recompute), and every gradient of a loss through z and
    the logdet; the stored and recomputed routes bit-equal.  ``x`` is the
    f32 stack input, rounded to bf16 for all.  Returns (the forward's worst
    max-abs error, the gradients' worst norm-relative error against the
    f32 plain version)."""
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    x16 = x.to(BF16)
    seed, fwd_worst = -20240230, 0.0
    with torch.no_grad():
        for rate in (FLOW_RATE, 0.0):
            k16 = flow_stack_train(x16, mask, weights, cond, pitch,
                                   seed=seed, dropout_rate=rate)
            k32 = flow_stack_train(x16.float(), mask, weights, cond, pitch,
                                   seed=seed, dropout_rate=rate)
            p16 = flow_stack_train_reference(x16, mask, weights, cond, pitch,
                                             seed=seed, dropout_rate=rate)
            p32 = flow_stack_train_reference(x16.float(), mask, weights,
                                             cond, pitch, seed=seed,
                                             dropout_rate=rate)
            torch.cuda.synchronize()
            err, bar = bf16_error(k16[0], p16[0], p32[0])
            ld_err, ld_bar = bf16_error(k16[1], p16[1], p32[1])
            line = (f'#5 bf16 {label} {tuple(x.shape)}, rate {rate}: z vs '
                    f'bf16 plain {err:.3e} (bar {bar:.3e}), logdet '
                    f'{ld_err:.3e} (bar {ld_bar:.3e}); bf16 kernel vs f32 '
                    f'kernel z '
                    f'{(k16[0].float() - k32[0]).abs().max().item():.3e}'
                    f', bf16 plain vs f32 plain '
                    f'{(p16[0].float() - p32[0]).abs().max().item():.3e}')
            print(line)
            assert err <= bar and ld_err <= ld_bar, line
            fwd_worst = max(fwd_worst, err)
        step, differing, elements, _ = dropout_mask_errors(
            x16, mask, weights, seed, BF16)
        print(f'#5 bf16 {label} dropout masks of flow step {step}: '
              f'{differing} differing elements of {elements}')
        assert differing == 0

    gen = torch.Generator().manual_seed(SEED + 105)
    dz = torch.randn(x.shape, generator=gen).to(x.device)
    dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(x.device)

    def gradients(fn, dtype):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = x16.to(dtype).detach().clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, cl, pl, seed=seed,
                   dropout_rate=FLOW_RATE)
        torch.autograd.backward((z.float(), ld), (dz, dld))
        torch.cuda.synchronize()
        out = {key: leaf.grad for key, leaf in leaves.items()}
        out['x'] = xl.grad.float()
        if cl is not None:
            out['cond'] = cl.grad
        if pl is not None:
            out['pitch'] = pl.grad
        return out

    p16 = gradients(flow_stack_train_reference, BF16)
    p32 = gradients(flow_stack_train_reference, torch.float32)
    k32 = gradients(forced_route('store'), torch.float32)
    got = gradients(forced_route('store'), BF16)
    recomputed = gradients(forced_route('recompute'), BF16)
    assert all(torch.equal(recomputed[key], got[key]) for key in got), \
        'stored and recomputed routes differ at bf16'
    to_f32 = to_bf16 = kernels = plains = 0.0
    for key in got:
        if p32[key].norm() == 0:
            continue
        a, own = norm_rel(got[key], p32[key]), norm_rel(p16[key], p32[key])
        rel16 = norm_rel(got[key], p16[key])
        assert a < BF16_GRAD_F32_BAR, (key, a)
        assert rel16 <= BF16_GRAD_FACTOR * own + BF16_GRAD_ATOL, (
            key, rel16, own)
        to_f32, to_bf16 = max(to_f32, a), max(to_bf16, rel16)
        kernels = max(kernels, norm_rel(got[key], k32[key]))
        plains = max(plains, own)
    print(f'#6 bf16 {label}: worst gradient norm-rel err {to_f32:.3e} '
          f'against the f32 plain version (bar {BF16_GRAD_F32_BAR:.0e}), '
          f'{to_bf16:.3e} against the bf16 plain version; bf16 kernel vs '
          f'f32 kernel {kernels:.3e}, bf16 plain vs f32 plain {plains:.3e}; '
          f'stored and recomputed routes bit-equal')
    return fwd_worst, to_f32


def bf16_train_launches(config, steps, eval_steps=0):
    """The launches of a bf16 train path: the init (a #3 bf16 launch per
    flow step), ``steps`` train steps (#5 and #6 bf16, one MAS each) and
    ``eval_steps`` eval steps under 'fused' (#3 bf16, one MAS each)."""
    flows = config.decoder.stack
    tag = build_suffix(config, pitch=config.uses_gradient_reversal)
    bwd = (BWD_PITCH_KERNELS_PER_FLOW_STEP if config.uses_gradient_reversal
           else BWD_KERNELS_PER_FLOW_STEP)
    return {**no_launches(),
            f'flow_step_bf16{tag}': flows * (1 + eval_steps),
            'mas': steps + eval_steps,
            f'train_fwd_bf16{tag}': flows * steps,
            f'train_bwd_bf16{tag}': bwd * flows * steps}


def run_bf16_training(config16, batch, device, steps=TRAIN_STEPS,
                      state=None, eval_steps=BF16_EVAL_STEPS):
    """The shipped YAML at bf16: the ActNorm init, ``steps`` train steps
    and ``eval_steps`` eval steps under 'fused', through the bf16 kernels,
    and the same init and steps through the plain versions at bf16 and at
    f32, from the same weights, seed and generator state; the losses of
    every step held to the bf16 bar as one vector.  Returns the kernels'
    launches of the path, and the kernels' metrics."""
    from glow_tts_tpu_torch import (initial_state_dict, make_eval_step,
                                    make_optimizer, make_train_step)
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    state = state if state is not None else initial_state_dict(config16,
                                                               SEED)
    config32 = dataclasses.replace(config16, compute_dtype='float32')
    runs = {}
    for name, config, step_fn, stack_fn, mas_fn in (
            ('kernels', config16, flow_step, flow_stack_train, maximum_path),
            # MAS through its kernel (bit-equal to its plain version, held
            # earlier): these runs are the flow kernels' references
            ('plain bf16', config16, flow_step_reference,
             flow_stack_train_reference, maximum_path),
            ('plain f32', config32, flow_step_reference,
             flow_stack_train_reference, maximum_path)):
        model = train_model(state, config, device)
        assert model.dtype == (BF16 if config is config16 else torch.float32)
        train_step = make_train_step(
            config, model, make_optimizer(config, model.parameters()),
            seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED),
            stack_fn=stack_fn, mas_fn=mas_fn)
        eval_step = make_eval_step(config, model, step_fn=step_fn,
                                   mas_fn=mas_fn)
        zero_counts()
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  step_fn=step_fn,
                                  **conditioning_inputs(batch))
        metrics = [train_step(batch) for _ in range(steps)]
        evals = [eval_step(batch)[0] for _ in range(eval_steps)]
        counts = read_counts()
        if name == 'kernels':
            launches = counts
        runs[name] = [{key: value.item() for key, value in m.items()}
                      for m in metrics + evals]
    keys = ['total', 'mle', 'duration'] + (
        ['speaker'] if config16.uses_gradient_reversal else [])
    vectors = {name: torch.tensor([[m[key] for key in keys] for m in run],
                                  dtype=torch.float64)
               for name, run in runs.items()}
    err, bar = bf16_error(*(vectors[name] for name in
                            ('kernels', 'plain bf16', 'plain f32')))
    mode = config16.mode
    for i, row in enumerate(runs['kernels']):
        kind = 'train step' if i < steps else 'eval step'
        print(f'  bf16 {mode} {kind} {i if i < steps else i - steps}: '
              + ' '.join(f'{key} {row[key]:.6f}' for key in keys)
              + (f' grad_norm {row["grad_norm"]:.5f}' if i < steps else '')
              + '; plain bf16 ' + ' '.join(
                  f'{key} {runs["plain bf16"][i][key]:.6f}' for key in keys)
              + '; plain f32 ' + ' '.join(
                  f'{key} {runs["plain f32"][i][key]:.6f}' for key in keys))
    print(f'bf16 {mode} train path ({steps} steps, {eval_steps} eval steps '
          f'under \'fused\'): losses kernels vs bf16 plain max abs err '
          f'{err:.3e} (bar {bar:.3e}, 2 x bf16 plain vs f32 plain); '
          f'launches {json.dumps({k: v for k, v in launches.items() if v})}')
    assert all(np.isfinite(v) for row in runs['kernels']
               for v in row.values())
    assert err <= bar, (err, bar)
    assert launches == bf16_train_launches(config16, steps, eval_steps), \
        launches
    return launches, runs['kernels']


def time_bf16_kernels(model, x, mask, weights, device, label,
                      cond=None, pitch=None, step_pitch=False, iters=3):
    """#3, #5 (storing, and under no_grad) and #6 of the bf16 build beside
    the f32 build on the same inputs (the stack's input rounded to bf16 for
    both), and the bf16 plain version; the bounds of the bf16 body at the
    bf16 peak and by its bytes (bf16 activations, f32 weights).  Returns
    the three rows of the kernels line."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train_reference)
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    b, t, c = x.shape
    full = torch.ones_like(mask)
    gen = torch.Generator().manual_seed(SEED + 107)
    xd = torch.randn((b, t, c), generator=gen).to(device)
    xd16, cond_d = xd.to(BF16), step.cond(b)
    pitch_d = (torch.rand((b, t, model.config.decoder.num_squeeze),
                          generator=gen).to(device) if step_pitch else None)
    w32, w16 = step.weights(False), step.weights(False, BF16)
    k16, k32 = paired_ms(
        lambda: flow_step(xd16, full, w16, cond_d, pitch=pitch_d),
        lambda: flow_step(xd16.float(), full, w32, cond_d, pitch=pitch_d),
        iters=5 * iters)
    plain16 = cuda_ms(lambda: flow_step_reference(xd16, full, w32, cond_d,
                                                  pitch=pitch_d), iters)
    per_step = {key: value for key, value in w32.items()
                if not key.endswith('_tc')}
    frame_flops = step_frame_flops(per_step)
    weight_bytes = 4 * sum(v.numel() for v in per_step.values())
    step_bounds = bf16_bounds(2 * 2 * xd.numel() + 4 * mask.numel()
                              + weight_bytes, frame_flops * b * t)
    print(f'#3 bf16 {label}, decode shape ({b}, {t}, {c}): bf16 build '
          f'{k16:.4f} ms, f32 build {k32:.4f} ms on the same inputs '
          f'({100 * (k16 / k32 - 1):+.1f} %), bf16 plain {plain16:.4f} ms; '
          f'bound {step_bounds["bound_ms"]:.4f} ms by '
          f'{step_bounds["bound_by"]} (operations at the bf16 peak '
          f'{step_bounds["ops_bound_ms"]:.4f} ms, bytes '
          f'{step_bounds["bytes_bound_ms"]:.4f} ms)')

    x16 = x.to(BF16)
    s_steps = weights['w_in'].shape[0]
    dz = torch.randn(x.shape, generator=gen).to(device)
    dld = torch.ones(b, device=device)
    times = {}
    for name, xin, fn, n_iters in (
            ('bf16', x16, forced_route('store'), iters),
            ('f32', x16.float(), forced_route('store'), iters),
            ('bf16 plain', x16, flow_stack_train_reference, 1)):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = xin.detach().clone().requires_grad_()

        def forward():
            return fn(xl, mask, leaves, cond, pitch, seed=SEED,
                      dropout_rate=FLOW_RATE)

        with torch.no_grad():
            no_grad_ms = cuda_ms(forward, n_iters, 1)
        fwd_ms = cuda_ms(forward, n_iters, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        z, ld = forward()
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            (z.float(), ld), [xl, *leaves.values()], (dz, dld),
            retain_graph=True), n_iters, 1)
        peak = torch.cuda.max_memory_allocated()
        times[name] = (fwd_ms / s_steps, no_grad_ms / s_steps,
                       bwd_ms / s_steps)
        print(f'flow stack {label} {tuple(x.shape)}, {s_steps} steps, '
              f'{name}: forward storing {fwd_ms / s_steps:.4f} ms per step '
              f'({no_grad_ms / s_steps:.4f} under no_grad), backward '
              f'{bwd_ms / s_steps:.4f} ms per step; peak memory of forward '
              f'+ backward {(peak - held) / 2 ** 30:.3f} GiB above the '
              f'{held / 2 ** 30:.3f} held')
        del z, ld
    ch, n = weights['w_in'].shape[3], weights['w_in'].shape[1]
    flops = frame_flops * mask.sum().item()
    fwd_bounds = bf16_bounds(2 * 2 * x.numel() + 4 * mask.numel()
                             + weight_bytes, flops)
    saved = coupling_grad.saved_bytes_per_step(b * t, c, ch, n, BF16)
    bwd_bounds = bf16_bounds(saved + 2 * x.numel() + 4 * (2 * x.numel())
                             + 2 * weight_bytes, 2 * flops)
    print(f'  per flow step {label}: #5 bf16 storing '
          f'{times["bf16"][0]:.4f} ms vs f32 {times["f32"][0]:.4f} ms; #6 '
          f'bf16 {times["bf16"][2]:.4f} ms vs f32 {times["f32"][2]:.4f} ms; '
          f'bounds #5 '
          f'{fwd_bounds["bound_ms"]:.4f} ms by {fwd_bounds["bound_by"]} '
          f'(bytes {fwd_bounds["bytes_bound_ms"]:.4f}), #6 '
          f'{bwd_bounds["bound_ms"]:.4f} ms by {bwd_bounds["bound_by"]} '
          f'(bytes {bwd_bounds["bytes_bound_ms"]:.4f}); '
          f'saved bytes a step {saved / 1e6:.0f} MB at bf16 (f32 '
          f'{coupling_grad.saved_bytes_per_step(b * t, c, ch, n) / 1e6:.0f}'
          f' MB)')
    return ({'ms': k16, 'f32_build_ms': k32, 'plain_ms': plain16,
             **step_bounds},
            {'ms': times['bf16'][0], 'no_grad_ms': times['bf16'][1],
             'f32_build_ms': times['f32'][0],
             'plain_ms': times['bf16 plain'][0], **fwd_bounds},
            {'ms': times['bf16'][2],
             'f32_build_ms': times['f32'][2],
             'plain_ms': times['bf16 plain'][2], **bwd_bounds})


def time_bf16_step(config16, batch, device):
    """The shipped YAML's train step at bf16 and at f32 on the same batch
    and weights, by CUDA events (f32, bf16, bf16, f32) and by device work
    (a profiler window each), with the peak memory of each."""
    from glow_tts_tpu_torch import (make_optimizer, make_train_step,
                                    random_state_dict)
    state = random_state_dict(config16, SEED)
    steps, peaks = {}, {}
    for dtype in ('bfloat16', 'float32'):
        config = dataclasses.replace(config16, compute_dtype=dtype)
        model = train_model(state, config, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'])
        step = make_train_step(
            config, model, make_optimizer(config, model.parameters()),
            seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED))
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step(batch)
        torch.cuda.synchronize()
        peaks[dtype] = (torch.cuda.max_memory_allocated() - held, held)
        steps[dtype] = step
    bf_ms, f_ms = paired_ms(lambda: steps['bfloat16'](batch),
                            lambda: steps['float32'](batch), iters=2,
                            plain_warmup=1)
    shape = tuple(batch['mels'].shape)
    print(f'train step {shape} by CUDA events: bf16 {bf_ms:.3f} ms, f32 '
          f'{f_ms:.3f} ms on the same batch ({100 * (bf_ms / f_ms - 1):+.1f} '
          f'%); peak memory above what is held, bf16 '
          f'{peaks["bfloat16"][0] / 2 ** 30:.3f} GiB, f32 '
          f'{peaks["float32"][0] / 2 ** 30:.3f} GiB')
    idle = {}
    for dtype in ('bfloat16', 'float32'):
        idle[dtype] = profile_window(f'train steps at {dtype}',
                                     lambda: steps[dtype](batch), 2,
                                     warmup=1, busy=True)
    return {'bf16_ms': bf_ms, 'f32_ms': f_ms,
            'bf16_idle_share': idle['bfloat16'][0],
            'bf16_busy_ms': idle['bfloat16'][1],
            'f32_idle_share': idle['float32'][0],
            'f32_busy_ms': idle['float32'][1],
            'bf16_peak_gib': peaks['bfloat16'][0] / 2 ** 30,
            'f32_peak_gib': peaks['float32'][0] / 2 ** 30}


def run_bf16_minispeech(device):
    """MiniSpeech at bf16 on the 80-channel bf16 builds: #3, #5 and #6
    against their plain versions, and a ``Trainer`` of the recipe as
    shipped for a few steps (the EM warmup and the decoder freeze over the
    first 2), its launches by part.  Returns the rows' errors and the
    launches by path."""
    import shutil
    import tempfile

    from glow_tts_tpu_torch import Trainer, random_state_dict
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    root = tempfile.mkdtemp(prefix='chip_smoke_bf16_minispeech_')
    try:
        config = minispeech_config(root, 'bfloat16')
        batch = minispeech_batch(config, device)
        state = random_state_dict(config, SEED + 95)
        f32 = dataclasses.replace(config, compute_dtype='float32')
        model = fresh_model(state, f32, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'])
        step_err = check_bf16_step(model, device, 'c80')
        trainee = train_model(state, f32, device)
        trainee.data_dependent_init(batch['mels'], batch['mel_lengths'])
        x, mask, weights = stack_problem(trainee, batch, f32)
        del trainee
        fwd_err, bwd_err = check_bf16_train(x, mask, weights, 'c80')
        rows = time_bf16_kernels(model, x, mask, weights, device, 'c80',
                                 iters=2)
        del model, x, mask, weights
        write_minispeech_archive(os.path.join(root, 'train'), TRAIN_PATTERNS,
                                 config, SEED + 93)
        write_minispeech_archive(os.path.join(root, 'eval'), EVAL_PATTERNS,
                                 config, SEED + 94)
        train = dataclasses.replace(
            config.train, max_step=MS_BF16_TRAINER_STEPS,
            checkpoint_save_interval=MS_BF16_TRAINER_STEPS,
            logging_interval=1, evaluation_interval=MS_BF16_TRAINER_STEPS,
            alignment_warmup_steps=MS_WARM_STEPS,
            decoder_freeze_steps=MS_WARM_STEPS)
        cfg = dataclasses.replace(
            config, train=train,
            checkpoint_path=os.path.join(root, 'bf16', 'checkpoint'),
            log_path=os.path.join(root, 'bf16', 'log'),
            inference_path=os.path.join(root, 'bf16', 'inference'))
        counts = PartCounts()
        trainer = counts.wrap('trainer init', lambda: Trainer(
            cfg, device=device,
            writers={'train': MemoryWriter(), 'eval': MemoryWriter()}))()
        assert trainer.model.dtype == BF16
        trainer.train_step = counts.wrap('trainer train',
                                         trainer.train_step)
        for key, fn in trainer.curriculum_steps.items():
            trainer.curriculum_steps[key] = counts.wrap('trainer train', fn)
        trainer.eval_step = counts.wrap('trainer eval', trainer.eval_step)
        trainer.model.inference_decode = counts.wrap(
            'trainer decode', trainer.model.inference_decode)
        trainer.train()
        logged = trainer.writers['train'].scalars
        totals = [value for _, value in logged['Loss/total']]
        print(f'MiniSpeech Trainer at bf16, {MS_BF16_TRAINER_STEPS} steps '
              f'(EM warmup and decoder freeze over the first '
              f'{MS_WARM_STEPS}): total loss by step {totals}; free-running '
              f'decode at {cfg.serve_dtype} finite')
        assert np.isfinite(totals).all() and len(totals) \
            == MS_BF16_TRAINER_STEPS, totals
        assert torch.isfinite(trainer.free_running['mels']).all()
        flows = config.decoder.stack
        expected = {
            'trainer init': {'flow_step_bf16_c80': flows},
            'trainer train': {
                'train_fwd_bf16_c80': flows * MS_BF16_TRAINER_STEPS,
                'train_bwd_bf16_c80': BWD_KERNELS_PER_FLOW_STEP * flows
                * MS_BF16_TRAINER_STEPS},
            # the free-running decodes (at steps 0 and 3) serve at
            # inference_dtype, f32
            'trainer decode': {'flow_step_c80': 2 * flows}}
        for part, want in expected.items():
            got = counts.by_part[part]
            print(f'  launches, MiniSpeech bf16 {part}: '
                  + json.dumps({key: v for key, v in got.items() if v}))
            for key, value in want.items():
                assert got[key] == value, (part, key, got)
        assert counts.by_part['trainer eval']['flow_step_bf16_c80'] > 0
        return ({'step': step_err, 'fwd': fwd_err, 'bwd': bwd_err},
                rows, {f'MiniSpeech bf16 {part}': value
                       for part, value in counts.by_part.items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_bf16_phase(inferencer_model, batches, device, card):
    """The bf16 phase: #3, #5 and #6's bf16 builds against their plain
    versions at full width (160 channels, the pitch builds, 80 channels),
    timed beside the f32 builds; the shipped YAML trained at bf16 (init,
    4 steps, eval steps under 'fused') beside the plain versions at bf16
    and f32; the train step at bf16 and f32 on the same batch; MiniSpeech's
    Trainer at bf16; one GR train step on the bf16 pitch builds.  Returns
    the kernels line's rows and the launches by path."""
    from glow_tts_tpu_torch import load_config, random_state_dict
    start = time.perf_counter()
    config16 = load_config(CONFIG)                    # as shipped
    assert config16.compute_dtype == 'bfloat16'
    f32 = dataclasses.replace(config16, compute_dtype='float32')
    batch = batches[0]
    errs, rows, by_path = {}, {}, {}
    errs['flow_step'] = check_bf16_step(inferencer_model, device, 'c160')
    trainee = train_model(random_state_dict(f32, SEED), f32, device)
    trainee.data_dependent_init(batch['mels'], batch['mel_lengths'])
    x, mask, weights = stack_problem(trainee, batch, f32)
    del trainee
    errs['flow_train_fwd'], errs['flow_train_bwd'] = check_bf16_train(
        x, mask, weights, 'c160')
    launches, _ = run_bf16_training(config16, batch, device)
    by_path['bf16 train and eval'] = launches
    (rows['flow_step'], rows['flow_train_fwd'],
     rows['flow_train_bwd']) = time_bf16_kernels(
        inferencer_model, x, mask, weights, device, 'c160')
    step_times = time_bf16_step(config16, batch, device)
    del x, mask, weights

    # GR on the bf16 pitch builds: #3, #5, #6 checked, one train step
    gr16 = mode_config('GR', dtype='bfloat16')
    gr32 = dataclasses.replace(gr16, compute_dtype='float32')
    gr_batch = conditioned_batch(gr32, device, SEED + 80)
    gr_state = random_state_dict(gr32, SEED + 81)
    gr_model = fresh_model(gr_state, gr32, device)
    errs['flow_step_pitch'] = check_bf16_step(gr_model, device, 'pitch',
                                              pitch=True)
    trainee = train_model(gr_state, gr32, device)
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    trainee.data_dependent_init(gr_batch['mels'], gr_batch['mel_lengths'],
                                **conditioning_inputs(gr_batch))
    x, mask, weights, cond, pitch = pitch_stack_problem(trainee, gr_batch,
                                                        gr32)
    del trainee
    errs['flow_train_fwd_pitch'], errs['flow_train_bwd_pitch'] = \
        check_bf16_train(x, mask, weights, 'pitch', cond, pitch)
    launches, _ = run_bf16_training(gr16, gr_batch, device, steps=1,
                                    state=gr_state, eval_steps=1)
    by_path['bf16 GR train and eval'] = launches
    (rows['flow_step_pitch'], rows['flow_train_fwd_pitch'],
     rows['flow_train_bwd_pitch']) = time_bf16_kernels(
        gr_model, x, mask, weights, device, 'pitch', cond, pitch,
        step_pitch=True, iters=2)
    del gr_model, x, mask, weights, cond, pitch

    ms_errs, ms_rows, ms_paths = run_bf16_minispeech(device)
    by_path.update(ms_paths)
    errs.update({'flow_step_c80': ms_errs['step'],
                 'flow_train_fwd_c80': ms_errs['fwd'],
                 'flow_train_bwd_c80': ms_errs['bwd']})
    (rows['flow_step_c80'], rows['flow_train_fwd_c80'],
     rows['flow_train_bwd_c80']) = ms_rows
    for name, err in errs.items():
        rows[name]['max_abs_err'] = err
        if name.startswith('flow_train_bwd'):
            rows[name]['max_abs_err_is'] = (
                'the worst gradient norm-relative error against the f32 '
                'plain version')
    print('bf16 phase: ' + json.dumps({
        'train_step': step_times, 'seconds': round(
            time.perf_counter() - start, 1), 'card': card}))
    return rows, by_path


# ---------------------------------------------------------------------------
# bfloat16 under every route (#2's and #4's bf16 builds), and GR at
# Num_Squeeze 1 (the pitch operand 1 wide)
# ---------------------------------------------------------------------------

ROUTE_EVAL_STEPS = 2           # eval steps under each route at bf16
GR1_TRAIN_STEPS = 3            # GR at Num_Squeeze 1: train steps a dtype


@torch.no_grad()
def flow_kernel_rows(model, device, eval_mask, label, dtype, pitch=False,
                     names=('coupling', 'flow_stack'), iters=10,
                     graph=False):
    """#3, #2 and #4 (those of ``names``) of the build at ``dtype`` for the
    model's flow width, with ``pitch`` its pitch build (the operand
    num_squeeze wide), on the model's packed weights and conditioning rows
    at B = 32, T = 512 (all frames valid: the decode shape) and on the eval
    batch's ragged mask, both directions.  Each against its plain version:
    at bf16 to the bf16 bar (max|kernel - plain_bf16| <= 2 max|plain_bf16
    - plain_f32| + 1e-6, the f32 plain version the reference), at f32 to
    Z_REL_BOUND; #4 bit for bit against launches of #3 of the same build,
    one a flow step.  Each timed beside a baseline on the same inputs
    (baseline, build, build, baseline): at bf16 the f32 build (the inputs
    rounded to bf16 for both), at f32 the build without the pitch operand;
    with its plain version and its bounds on the valid frames (at bf16 the
    bf16 tensor-core peak).  With ``graph``, #3 and #2 at the decode shape
    also by CUDA graph (20 launches a replay: the device time without the
    host's share between launches; ``graph_ms``, ``forward_graph_ms``) and
    #4 by CUDA events.  Returns a row a name."""
    from glow_tts_tpu_torch.tools.time_flow import graph_ms
    from glow_tts_tpu_torch.ops.coupling import (
        WEIGHT_KEYS, coupling, coupling_reference, flow_stack,
        flow_stack_reference, flow_step, flow_step_reference, kernel_keys)
    decoder = model.layer_Dict['Decoder']
    flows = list(decoder.layer_Dict['Flows'])
    step = flows[0]
    c = step.layers[0].logs.shape[1]
    c2 = c // 2
    bf16 = dtype == BF16
    gen = torch.Generator().manual_seed(SEED + 140)
    t_all = max(512, eval_mask.shape[1])
    x, _ = ragged_batch(gen, GR_BATCH, t_all, c, device)
    if pitch:
        speakers = torch.randint(model.config.speaker_embedding.num_speakers,
                                 (GR_BATCH,), generator=gen).to(device)
        prosody = (torch.randn((GR_BATCH, model.config.prosody_encoder.size),
                               generator=gen) * 0.3).to(device)
        cond = decoder.conditioning(GR_BATCH,
                                    model.layer_Dict['LUT'](speakers),
                                    prosody, pitch=True)
        p = torch.rand((GR_BATCH, t_all, model.config.decoder.num_squeeze),
                       generator=gen).to(device)
    else:
        cond, p = decoder.stacked_cond(GR_BATCH), None
    x = x.to(dtype).float()               # the same values at both dtypes
    t_eval = eval_mask.shape[1]
    xd = x[:, :512].contiguous()
    xe = (x[:, :t_eval] * eval_mask).contiguous()
    # (x, mask, pitch operand) of each shape
    shapes = {'decode': (xd, torch.ones_like(xd[..., :1]),
                         None if p is None else p[:, :512].contiguous()),
              'eval': (xe, eval_mask,
                       None if p is None else p[:, :t_eval].contiguous())}

    def own(weights):
        return {**coupling_weights(weights),
                **({'w_pitch': weights['w_pitch']} if pitch else {})}

    def fns(name, at):
        """(kernel, plain) of ``name`` on inputs cast to ``at``."""
        if name == 'flow_step':
            return (lambda xs, m, r, q: flow_step(
                        xs.to(at), m, step.weights(r, at), cond[0], r,
                        pitch=q),
                    lambda xs, m, r, q: flow_step_reference(
                        xs.to(at), m, step.weights(r), cond[0], r, q))
        if name == 'coupling':
            return (lambda xs, m, r, q: coupling(
                        xs.to(at)[..., :c2], xs.to(at)[..., c2:], m,
                        own(step.weights(r, at)), cond[0], pitch=q,
                        reverse=r),
                    lambda xs, m, r, q: coupling_reference(
                        xs.to(at)[..., :c2], xs.to(at)[..., c2:], m,
                        own(step.weights(r)), cond[0], q, r))
        return (lambda xs, m, r, q: flow_stack(
                    xs.to(at), m, decoder.stacked_weights(r, at), cond, q, r),
                lambda xs, m, r, q: flow_stack_reference(
                    xs.to(at), m, decoder.stacked_weights(r), cond, q, r))

    def weight_count(weights):
        return sum(weights[key].numel() for key in kernel_keys(
            (*WEIGHT_KEYS, 'ld_const', 'w_pitch')) if key in weights)

    act = 2 if bf16 else 4
    rows = {}
    for name in names:
        steps = len(flows) if name == 'flow_stack' else 1
        kernel_fn, plain_fn = fns(name, dtype)
        kernel32, plain32 = fns(name, torch.float32)
        weights = (decoder.stacked_weights(False) if name == 'flow_stack'
                   else own(step.weights(False)) if name == 'coupling'
                   else step.weights(False))
        frame_flops = step_frame_flops(
            own(step.weights(False)) if name == 'coupling'
            else step.weights(False))
        ps = 0 if p is None else p.shape[-1]
        pitch_flops = 2 * ps * cond.shape[-1] * cond.shape[-3]
        row = {'max_abs_err': 0.0}
        for shape, (xs, m, p) in shapes.items():
            for reverse in (False, True):
                z_k, ld_k = kernel_fn(xs, m, reverse, p)
                z_p, ld_p = plain_fn(xs, m, reverse, p)
                torch.cuda.synchronize()
                assert torch.isfinite(z_k.float()).all(), (label, name)
                line = f'{name} {label} {shape} shape reverse={reverse}: '
                if bf16:
                    z_32, ld_32 = plain32(xs, m, reverse, p)
                    err, bar = bf16_error(z_k, z_p, z_32)
                    line += (f'kernel vs bf16 plain max abs err {err:.3e} '
                             f'(bar {bar:.3e})')
                    ok = err <= bar
                    if not reverse:
                        ld_err, ld_bar = bf16_error(ld_k, ld_p, ld_32)
                        line += f', logdet {ld_err:.3e} (bar {ld_bar:.3e})'
                        ok = ok and ld_err <= ld_bar
                else:
                    err = (z_k - z_p).abs().max().item()
                    rel = rel_err(z_k, z_p)
                    line += (f'kernel vs plain max abs err {err:.3e}, max '
                             f'rel err {rel:.3e}')
                    ok = rel < Z_REL_BOUND
                    if not reverse:
                        ld_rel = rel_err(ld_k, ld_p)
                        line += f', logdet rel err {ld_rel:.3e}'
                        ok = ok and ld_rel < LD_REL_BOUND
                if name == 'flow_stack':
                    chained = xs.to(dtype)
                    for k in (reversed(range(steps)) if reverse
                              else range(steps)):
                        chained, _ = flow_step(chained, m,
                                               flows[k].weights(reverse,
                                                                dtype),
                                               cond[k], reverse, pitch=p)
                    same = torch.equal(z_k, chained)
                    line += (f'; z bit-equal to {steps} chained flow-step '
                             f'launches of the same build: {same}')
                    ok = ok and same
                print(line)
                assert ok, line
                row['max_abs_err'] = max(row['max_abs_err'], err)
            valid = m.sum().item()
            flops = (frame_flops + pitch_flops) * valid * steps
            # the activations in and out at the build's width (the coupling
            # writes z_b alone), the rest f32: mask, conditioning rows,
            # logdet, pitch operand, weights
            out = xs.numel() // 2 if name == 'coupling' else xs.numel()
            rows_read = (cond.numel() if name == 'flow_stack'
                         else cond[0].numel())
            moved = (act * (xs.numel() + out)
                     + 4 * (m.numel() + rows_read + xs.shape[0]
                            + ps * xs.shape[0] * xs.shape[1]
                            + weight_count(weights)))
            bounds = (bf16_bounds(moved, flops) if bf16
                      else body_bounds(moved, flops))
            for reverse in (True, False):
                if bf16:
                    ms, base_ms = paired_ms(
                        lambda: kernel_fn(xs, m, reverse, p),
                        lambda: kernel32(xs, m, reverse, p), iters)
                    base = 'f32 build'
                else:
                    ms, base_ms = paired_ms(
                        lambda: kernel_fn(xs, m, reverse, p),
                        lambda: kernel_fn(xs, m, reverse, None), iters)
                    base = 'build without the pitch operand'
                plain_ms = cuda_ms(lambda: plain_fn(xs, m, reverse, p), 1, 1)
                print(f'{name} {label} {shape} shape ({int(valid)} valid '
                      f'frames) reverse={reverse}: {ms:.4f} ms, {base} '
                      f'{base_ms:.4f} ms on the same inputs '
                      f'({100 * (ms / base_ms - 1):+.1f} %), plain '
                      f'{plain_ms:.4f} ms; bound {bounds["bound_ms"]:.4f} ms '
                      f'by {bounds["bound_by"]}')
                key = ('' if shape == 'decode' else 'eval_shape_') + (
                    '' if reverse else 'forward_')
                row.update({f'{key}ms': ms,
                            f'{key}{"f32_build" if bf16 else "vanilla"}_ms':
                            base_ms, f'{key}plain_ms': plain_ms})
            if shape == 'decode':
                row.update(bounds)
                for reverse in (True, False) if graph else ():
                    key = '' if reverse else 'forward_'
                    stack = name == 'flow_stack'
                    row[f'{key}graph_ms'] = (
                        cuda_ms(lambda: kernel_fn(xs, m, reverse, p), 3)
                        if stack else
                        graph_ms(lambda: kernel_fn(xs, m, reverse, p)))
                    print(f'{name} {label} decode shape reverse={reverse}: '
                          f'{row[f"{key}graph_ms"]:.4f} ms by CUDA '
                          f'{"events" if stack else "graph"}, bound '
                          f'{bounds["bound_ms"]:.4f} ms by '
                          f'{bounds["bound_by"]}')
            else:
                row['eval_shape_bound_ms'] = bounds['bound_ms']
        if bf16 and name == 'coupling':
            row['schedule'] = check_coupling_identity(step, shapes, cond[0],
                                                      label)
        rows[name] = row
    return rows


def check_coupling_identity(step, shapes, cond, label):
    """#2 bf16 against #3 bf16 on an identity ActNorm (logs and bias 0) and
    mixing (I, zero-padded in the ring's slices) with no per-frame logdet
    constant, on each of ``shapes`` (name: (x, mask, pitch operand)) in both
    directions: #3's z must be [x_a, z_b of #2] bit for bit and the forward
    logdets equal, since both run the ring body's WaveNet and affine; and
    the tiles #2 reports held against its schedule of the ring body's time
    tile (48 frames at the shipped halo).  Returns the tiles and rounds of
    each shape."""
    from glow_tts_tpu_torch.ops.coupling import (_coupling_kernel, flow_step,
                                                 geometry,
                                                 load_coupling_library,
                                                 ring_weights, shape_of)
    c = step.layers[0].logs.shape[1]
    c2 = c // 2
    flow_shape = shape_of(c, step.weights(False)['w_in'].shape)
    eye = torch.eye(c, device=cond.device)

    def own(weights, p):
        return {**coupling_weights(weights),
                **({'w_pitch': weights['w_pitch']} if p is not None else {})}
    out = {}
    for shape, (xs, m, p) in shapes.items():
        x16 = xs.to(BF16)
        for reverse in (False, True):
            w = dict(step.weights(reverse, BF16))
            w.update(an_logs=torch.zeros_like(w['an_logs']),
                     an_bias=torch.zeros_like(w['an_bias']), mix_t=eye,
                     **ring_weights({'mix_t': eye}))
            if not reverse:
                w['ld_const'] = torch.zeros_like(w['ld_const'])
            z, ld = flow_step(x16, m, w, cond, reverse, pitch=p)
            z_b, ld_b = _coupling_kernel(x16[..., :c2], x16[..., c2:], m,
                                         own(w, p), cond, p, reverse)
            torch.cuda.synchronize()
            # elements apart: z_b, x_a passed through #3, the logdets
            apart = [(z[..., c2:] != z_b).sum().item(),
                     (z[..., :c2] != (x16[..., :c2].float() * m).to(BF16)
                      ).sum().item(),
                     0 if reverse else (ld != ld_b).sum().item()]
            ok = not any(apart)
            line = (f'coupling {label} {shape} shape reverse={reverse}: #2 '
                    f'bf16 z_b and logdet bit-equal to #3 bf16 on an identity'
                    f' ActNorm and mixing: {ok} (elements apart: z_b '
                    f'{apart[0]}, x_a {apart[1]}, logdet {apart[2]})')
            print(line)
            assert ok, line
        lib = load_coupling_library(0 if p is None else p.shape[-1],
                                    flow_shape, True)
        tile = lib.glow_coupling_time_tile()
        w16 = own(step.weights(False, BF16), p)
        got = live_tiles(m, lambda tiles: _coupling_kernel(
            x16[..., :c2], x16[..., c2:], m, w16, cond, p, tiles=tiles),
            tile=tile)
        n_tiles = -(-m.shape[1] // tile)
        assert tile == geometry(flow_shape, True, 0 if p is None
                                else p.shape[-1])['time_tile'], tile
        assert got['items'] == m.shape[0] * n_tiles, got
        assert got['blocks'] == min(lib.glow_coupling_resident_blocks(
            m.shape[0]), got['items']), got
        print(f'coupling {label} live tiles, {shape} shape '
              f'{tuple(m.shape[:2])}, as the kernel reports them: '
              f'{got["computed"]} of {got["items"]} items ({tile}-frame '
              f'tiles, {n_tiles} a sample) computed, {got["rounds"]} rounds '
              f'on {got["blocks"]} blocks')
        out[shape] = {'live_tiles': got['computed'], 'tiles': got['items'],
                      'rounds': got['rounds'], 'blocks': got['blocks']}
    return out


def routes_eval(config, state, batch, device, label, steps=1,
                routes=tuple(ROUTES), plain=True):
    """The ActNorm init and ``steps`` eval steps on ``batch`` under each of
    ``routes`` from the same weights, through the kernels of the config's
    compute dtype (counted: init and eval apart), and, with ``plain``,
    through the plain versions of each route at that dtype and at f32; the
    losses held to the plain versions (at bf16 to the bf16 bar with the
    f32 plain version the reference, at f32 to LOSS_REL_BOUND) and each
    route against 'fused'.  Returns (the launches by path, the kernels'
    losses by route)."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.ops.coupling import flow_step
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    bf16 = config.compute_dtype == 'bfloat16'
    gr = config.uses_gradient_reversal
    keys = ['mle', 'duration', 'total'] + (['speaker'] if gr else [])
    by_path, losses = {}, {}
    for route in routes:
        cfg = dataclasses.replace(config, coupling_backend=route)
        runs = {}
        for name, run_cfg, fn_kwargs in (
                ('kernels', cfg, {}),
                ('plain', cfg, plain_flow_fns()),
                ('plain f32', dataclasses.replace(cfg,
                                                  compute_dtype='float32'),
                 plain_flow_fns()))[:3 if plain and bf16 else
                                    2 if plain else 1]:
            model = fresh_model(state, run_cfg, device)
            zero_counts()
            model.data_dependent_init(
                batch['mels'], batch['mel_lengths'],
                step_fn=fn_kwargs.get('step_fn', flow_step),
                **conditioning_inputs(batch))
            init_counts = read_counts()
            eval_step = make_eval_step(run_cfg, model, **fn_kwargs)
            zero_counts()
            results = [eval_step(batch)[0] for _ in range(steps)]
            counts = read_counts()
            runs[name] = torch.tensor(
                [[r[key].item() for key in keys] for r in results],
                dtype=torch.float64)
            if name == 'kernels':
                flows = cfg.decoder.stack
                init_expected = {**no_launches(),
                                 'flow_step' + build_suffix(
                                     cfg, pitch=gr, bf16=bf16): flows}
                expected = {**route_launches(route, cfg, steps, pitch=gr),
                            'mas': steps}
                assert init_counts == init_expected, (route, init_counts)
                assert counts == expected, (route, counts)
                by_path[f'{label} init {route}'] = init_counts
                by_path[f'{label} eval {route}'] = counts
        assert torch.isfinite(runs['kernels']).all(), (label, route)
        line = (f'{label} eval under {route!r} ({steps} steps): kernels '
                + ' '.join(f'{key} {v:.6f}' for key, v in
                           zip(keys, runs['kernels'][-1].tolist())))
        if plain and bf16:
            err, bar = bf16_error(runs['kernels'], runs['plain'],
                                  runs['plain f32'])
            line += (f'; vs bf16 plain max abs err {err:.3e} (bar {bar:.3e}'
                     f', plain f32 total {runs["plain f32"][-1, 2]:.6f})')
            assert err <= bar, line
        elif plain:
            err = (runs['kernels'] - runs['plain']).abs().max().item()
            line += f'; vs plain max abs err {err:.3e}'
            assert (err <= LOSS_REL_BOUND
                    * runs['plain'].abs().max().item()), line
        print(line)
        losses[route] = runs
    if 'fused' in losses:
        for route in losses:
            if route == 'fused':
                continue
            diff = (losses[route]['kernels']
                    - losses['fused']['kernels']).abs().max().item()
            line = (f'{label} eval {route!r} vs \'fused\': max abs diff '
                    f'{diff:.3e}')
            if route == 'mega' or not bf16:
                # 'mega': the same body step after step, so z is the same
                # bits; its logdet sums the steps' tile sums in another
                # order
                assert diff <= LOSS_REL_BOUND * losses['fused'][
                    'kernels'].abs().max().item(), line
            elif plain:
                # two bf16 policies ('modules' keeps the stream in the
                # input's dtype between its modules, as JAX's flax route):
                # no further apart than their distances from f32 allow
                bar = BF16_FACTOR * max(
                    (losses[r]['plain'] - losses[r]['plain f32']).abs()
                    .max().item() for r in (route, 'fused')) + BF16_ATOL
                line += f' (bar {bar:.3e})'
                assert diff <= bar, line
            print(line)
    return by_path, {route: runs['kernels'] for route, runs in losses.items()}


def time_route_evals(config, state, batch, device, label):
    """The eval step at the config's dtype under each route, by CUDA
    events, the routes in turn (fused, modules, mega, mega, modules,
    fused), after one warm-up each."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    steps = {}
    for route in ROUTES:
        cfg = dataclasses.replace(config, coupling_backend=route)
        model = fresh_model(state, cfg, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  **conditioning_inputs(batch))
        steps[route] = make_eval_step(cfg, model)
    order = list(ROUTES) + list(reversed(ROUTES))
    times = {route: [] for route in ROUTES}
    for route in order:
        times[route].append(cuda_ms(lambda: steps[route](batch), 3, 1))
    result = {route: sum(v) / len(v) for route, v in times.items()}
    print(f'eval step {label} {tuple(batch["mels"].shape)} at '
          f'{config.compute_dtype} by CUDA events: ' + ', '.join(
              f'{route!r} {ms:.3f} ms' for route, ms in result.items()))
    return result


def serve_bf16_routes(config, state, items, device, label):
    """An ``Inferencer`` at ``inference_dtype`` bfloat16 under each route
    serving ``items`` in one decode at B = 32 in the 1024-frame bucket
    (counted: the route's bf16 build), and the decode phase on one prior
    (the f32 model's) and one noise at bf16 under each route and at f32:
    'mega' bit-equal to 'fused', every route's mels no further from the f32
    decode than twice 'fused''s (mean absolute error on the valid frames,
    plus 1e-6)."""
    from glow_tts_tpu_torch import Inferencer
    gr = config.uses_gradient_reversal
    serving = dataclasses.replace(config, compute_dtype='bfloat16',
                                  inference_dtype='bfloat16')
    by_path, mels = {}, {}
    f32 = Inferencer(state, dataclasses.replace(
        config, compute_dtype='float32', inference_dtype='float32'), device,
        batch_size=GR_BATCH)
    _, prior = prior_of(f32, items)
    scale = 960.0 / prior['durations'].sum(dim=1).max().item()
    items = [dict(item, length_scale=scale) for item in items]
    batch, prior = prior_of(f32, items)
    noise = torch.randn((len(items), 1024, config.sound.mel_dim),
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED + 150), device=device)
    extra = ({'pitches': batch['pitches'],
              'pitch_lengths': batch['pitch_lengths']} if gr else {})
    with torch.no_grad():
        ref = f32.model.inference_decode(prior, noise=noise,
                                         max_mel_length=1024, **extra)
    for route in ROUTES:
        cfg = dataclasses.replace(serving, coupling_backend=route)
        inferencer = Inferencer(state, cfg, device, batch_size=GR_BATCH)
        assert inferencer.model.dtype == BF16
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        expected = route_launches(route, cfg, 1, pitch=gr)
        assert launches == expected, (label, route, launches)
        for r in results:
            assert r['bucket'] == 1024, r['bucket']
            assert np.isfinite(r['mel']).all(), r['label']
        by_path[f'{label} serve bf16 {route}'] = launches
        with torch.no_grad():
            mels[route] = inferencer.model.inference_decode(
                prior, noise=noise, max_mel_length=1024, **extra)['mels']
    valid = (torch.arange(1024, device=device)[None, :]
             < ref['mel_lengths'][:, None])[..., None]

    def mae(a, b):
        return (((a - b).abs() * valid).sum()
                / (valid.sum() * a.shape[-1])).item()

    to_f32 = {route: mae(mel, ref['mels']) for route, mel in mels.items()}
    print(f'{label} served at bf16 under each route (B={len(items)}, bucket '
          f'1024): launches as expected; decode mel MAE against the f32 '
          f'decode ' + ', '.join(f'{r!r} {v:.3e}' for r, v in to_f32.items())
          + f'; \'mega\' bit-equal to \'fused\': '
          f'{torch.equal(mels["mega"], mels["fused"])}')
    assert torch.equal(mels['mega'], mels['fused'])
    for route, value in to_f32.items():
        assert value <= 2 * to_f32['fused'] + 1e-6, (label, route, to_f32)
    return by_path


def run_bf16_routes_phase(batches, device, card):
    """bf16 under 'modules' (#2's bf16 builds) and 'mega' (#4's): at the
    shipped YAML as loaded (Vanilla, 160 channels), at MiniSpeech's 80
    channels and in GR mode (the pitch builds): each kernel against its
    plain version and timed beside its f32 build; the ActNorm init and two
    eval steps under each route beside the plain versions at bf16 and f32
    and against 'fused'; an Inferencer at inference_dtype bfloat16 under
    each route; the eval step at bf16 under each route timed.  Returns the
    kernels line's rows and the launches by path."""
    import shutil
    import tempfile

    from glow_tts_tpu_torch import load_config, random_state_dict
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.text import text_filtering
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    start = time.perf_counter()
    root = tempfile.mkdtemp(prefix='chip_smoke_bf16_routes_')
    rows, by_path, eval_ms = {}, {}, {}
    try:
        shipped = load_config(CONFIG)
        assert shipped.compute_dtype == 'bfloat16'
        gr16 = mode_config('GR', dtype='bfloat16')
        ms16 = minispeech_config(root, 'bfloat16')
        cases = (('c160', shipped, batches[1], SEED + 160, ''),
                 ('c80', ms16, minispeech_batch(ms16, device), SEED + 161,
                  '_c80'),
                 ('pitch', gr16, conditioned_batch(gr16, device, SEED + 162),
                  SEED + 163, '_pitch'))
        for label, config16, batch, seed, tag in cases:
            state = random_state_dict(config16, seed)
            gr = config16.uses_gradient_reversal
            f32 = dataclasses.replace(config16, compute_dtype='float32')
            model = fresh_model(state, f32, device)
            model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                      **conditioning_inputs(batch))
            _, eval_mask = squeeze(
                batch['mels'], sequence_mask(batch['mel_lengths'],
                                             batch['mels'].shape[1]),
                config16.decoder.num_squeeze)
            for name, row in flow_kernel_rows(
                    model, device, eval_mask, f'bf16 {label}', BF16,
                    pitch=gr, names=('flow_step', 'coupling',
                                     'flow_stack')).items():
                rows[f'{name}_bf16{tag}'] = row
            del model
            paths, _ = routes_eval(config16, state, batch, device,
                                   f'bf16 {label}', ROUTE_EVAL_STEPS)
            by_path.update(paths)
            eval_ms[label] = time_route_evals(config16, state, batch,
                                              device, f'bf16 {label}')
            if gr:
                items = conditioned_items(
                    config16, [INFERENCE_TEXTS[i % 4]
                               for i in range(GR_BATCH)], SEED + 165)
            else:
                texts = ([item['text'] for item in minispeech_items(
                    GR_BATCH, SEED + 164)] if label == 'c80' else
                    [text_filtering(INFERENCE_TEXTS[i % 4])
                     for i in range(GR_BATCH)])
                items = [{'label': f'v{i}', 'text': text}
                         for i, text in enumerate(texts)]
            by_path.update(serve_bf16_routes(config16, state, items, device,
                                             f'bf16 {label}'))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print('bf16 routes phase: ' + json.dumps({
        'eval_step_ms': eval_ms,
        'seconds': round(time.perf_counter() - start, 1), 'card': card}))
    return rows, by_path


def gr_squeeze1_config(dtype='float32'):
    """The shipped YAML in GR mode with ``decoder.num_squeeze`` 1 on the
    loaded config (no YAML edited): 80 flow channels, the shipped
    WaveNet, the pitch operand 1 wide."""
    config = mode_config('GR', dtype=dtype)
    return dataclasses.replace(config, decoder=dataclasses.replace(
        config.decoder, num_squeeze=1))


def run_gr_squeeze1_phase(pitch_rows, train_pitch_rows, device, card):
    """GR at ``Num_Squeeze: 1`` on the pitch builds whose operand is 1 wide
    (the 80-channel pitch builds): #3, #2 and #4 at f32 and bf16
    against their plain versions; #5 and #6 at f32 (both routes,
    bit-equal) and bf16 against theirs; each timed beside the build
    without the pitch operand (f32) or the f32 build (bf16), and beside
    the 160-channel pitch build's time on the same B and T from the
    conditioned phases; the ActNorm init and 3 train steps at f32 and at
    bf16 beside the plain versions step by step; an eval step under each
    route at both dtypes; one decode at each.  Returns the kernels line's
    rows and the launches by path."""
    from glow_tts_tpu_torch import Inferencer, random_state_dict
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops.coupling import pitch_width
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    start = time.perf_counter()
    gr32 = gr_squeeze1_config()
    gr16 = dataclasses.replace(gr32, compute_dtype='bfloat16')
    c = gr32.sound.mel_dim * gr32.decoder.num_squeeze
    assert (c, pitch_width(gr32)) == (80, 1), c
    batch = conditioned_batch(gr32, device, SEED + 170)
    state = random_state_dict(gr32, SEED + 171)
    rows, by_path = {}, {}

    model = fresh_model(state, gr32, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              **conditioning_inputs(batch))
    _, eval_mask = squeeze(batch['mels'], sequence_mask(
        batch['mel_lengths'], batch['mels'].shape[1]), 1)
    names = ('flow_step', 'coupling', 'flow_stack')
    for dtype, tag in ((torch.float32, '_c80_pitch'),
                       (BF16, '_bf16_c80_pitch')):
        for name, row in flow_kernel_rows(
                model, device, eval_mask, f'GR squeeze 1 {dtype}', dtype,
                pitch=True, names=names).items():
            row['c160_pitch_build_ms'] = pitch_rows[name]['ms']
            rows[name + tag] = row

    trainee = train_model(state, gr32, device)
    trainee.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                **conditioning_inputs(batch))
    x, mask, weights, cond, pitch = pitch_stack_problem(trainee, batch, gr32)
    del trainee
    assert pitch.shape[-1] == 1
    fwd_err = check_train_pitch_forward(x, mask, weights, cond, pitch)
    bwd_err = check_train_backward(x, mask, weights, cond, pitch)
    fwd_row, bwd_row = time_train_pitch_kernels(x, mask, weights, cond, pitch)
    fwd16, bwd16 = check_bf16_train(x, mask, weights, 'GR squeeze 1', cond,
                                    pitch)
    _, fwd16_row, bwd16_row = time_bf16_kernels(
        model, x, mask, weights, device, 'GR squeeze 1', cond, pitch,
        step_pitch=True, iters=2)
    del x, mask, weights, cond, pitch, model
    for name, row, err in (
            ('flow_train_fwd_c80_pitch', fwd_row, fwd_err),
            ('flow_train_bwd_c80_pitch', bwd_row, bwd_err),
            ('flow_train_fwd_bf16_c80_pitch', fwd16_row, fwd16),
            ('flow_train_bwd_bf16_c80_pitch', bwd16_row, bwd16)):
        row['max_abs_err'] = err
        row['c160_pitch_build_ms'] = train_pitch_rows[
            name.split('_c80')[0].replace('_bf16', '')]['ms']
        if 'bwd_bf16' in name:
            row['max_abs_err_is'] = (
                'the worst gradient norm-relative error against the f32 '
                'plain version')
        rows[name] = row

    by_path['GR squeeze 1 train f32'] = run_training(
        gr32, batch, device, GR1_TRAIN_STEPS, state=state)
    by_path['GR squeeze 1 train bf16'], _ = run_bf16_training(
        gr16, batch, device, GR1_TRAIN_STEPS, state=state, eval_steps=0)
    for config in (gr32, gr16):
        paths, _ = routes_eval(config, state, batch, device,
                               f'GR squeeze 1 {config.compute_dtype}')
        by_path.update(paths)
    items = conditioned_items(gr32, [INFERENCE_TEXTS[i % 4]
                                     for i in range(MODE_BATCH)], SEED + 172)
    for dtype in ('float32', 'bfloat16'):
        cfg = dataclasses.replace(gr32, compute_dtype=dtype,
                                  inference_dtype=dtype)
        inferencer = Inferencer(state, cfg, device, batch_size=MODE_BATCH)
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        assert launches == route_launches('fused', cfg, 1, pitch=True), \
            launches
        for r in results:
            assert np.isfinite(r['mel']).all() and r['mel'].shape[1] == 80
        print(f'GR squeeze 1 served {len(results)} requests at {dtype}: '
              f'mels {[r["mel"].shape[0] for r in results]} frames, '
              'launches '
              + json.dumps({k: v for k, v in launches.items() if v}))
        by_path[f'GR squeeze 1 serve {dtype}'] = launches
    print('GR squeeze 1 phase: ' + json.dumps({
        'seconds': round(time.perf_counter() - start, 1), 'card': card}))
    return rows, by_path


# ---------------------------------------------------------------------------
# data parallelism: each rank a process of this script
# (``python3 chip_smoke.py --data-parallel-rank KIND OUT``, with the
# environment torchrun gives a rank)
# ---------------------------------------------------------------------------

# the B.2 phase: the config's overrides of each of B2_SHAPES (the shipped
# YAML's dict, no new YAML), and its mode
B2_OVERRIDES = {
    'c200': ('Vanilla', {'Sound': {'Mel_Dim': 100}}),
    'c200_pitch': ('GR', {'Sound': {'Mel_Dim': 100}}),
    'c16_ch16_l2_k5': ('Vanilla', {'Sound': {'Mel_Dim': 8}, 'Decoder': {
        'Affine_Coupling': {'Calc_Channels': 16, 'WaveNet': {
            'Num_Layers': 2, 'Kernel_Size': 5}}}}),
    'c160_ch128_l16_k3': ('Vanilla', {'Decoder': {'Affine_Coupling': {
        'Calc_Channels': 128, 'WaveNet': {'Num_Layers': 16,
                                          'Kernel_Size': 3}}}}),
    # 128-bin mels; 100-bin mels at MiniSpeech's Num_Squeeze 1 (its only
    # decoder setting the shipped YAML does not share; the encoder keeps
    # the shipped vocabulary), Vanilla and GR; 100 bins at 8 layers
    'c256': ('Vanilla', {'Sound': {'Mel_Dim': 128}}),
    'c100': ('Vanilla', {'Sound': {'Mel_Dim': 100},
                         'Decoder': {'Num_Squeeze': 1}}),
    'c100_pitch': ('GR', {'Sound': {'Mel_Dim': 100},
                          'Decoder': {'Num_Squeeze': 1}}),
    'c200_l8': ('Vanilla', {'Sound': {'Mel_Dim': 100}, 'Decoder': {
        'Affine_Coupling': {'WaveNet': {'Num_Layers': 8}}}}),
}
# the routes whose init and eval step the B.2 phase runs of a build, where
# not all three; the builds whose init, eval and serving it holds to the
# plain versions (each serves B = 32 through an Inferencer under each
# route, at f32 and bf16)
B2_ROUTES = {'c100_pitch': ('fused',), 'c200_l8': ('fused',)}
B2_FULL = ('c200', 'c256', 'c100')
B2_KERNEL_ITERS = 3            # timed launches a pair (flow_kernel_rows)


def shipped_with(mode, overrides, dtype='float32', route='fused'):
    """The shipped YAML with ``overrides`` merged into its dict, in
    ``mode``, under ``route`` at ``dtype``."""
    import yaml
    from glow_tts_tpu_torch import load_config

    def merge(into, new):
        for key, value in new.items():
            if isinstance(value, dict):
                merge(into.setdefault(key, {}), value)
            else:
                into[key] = value
    with open(CONFIG, encoding='utf-8') as f:
        data = yaml.safe_load(f)
    data['Mode'] = mode
    merge(data, overrides)
    return dataclasses.replace(load_config(data), coupling_backend=route,
                               compute_dtype=dtype)


def b2_config(label, dtype='float32', route='fused'):
    """The shipped YAML with ``B2_OVERRIDES[label]`` merged into its dict
    (100-bin mels; tiny_config's decoder; another WaveNet), in its mode,
    under ``route`` at ``dtype``."""
    return shipped_with(*B2_OVERRIDES[label], dtype, route)


def serve_b2_f32(config, state, items, device, label):
    """An ``Inferencer`` at f32 under each route serving ``items`` in one
    decode at B = 32 in the 1024-frame bucket (counted: the route's f32
    build), and the decode phase on one prior and one noise through each
    route's kernel and its plain version: mel MAE over the valid frames
    within MEL_MAE_BOUND, 'mega' bit-equal to 'fused'."""
    from glow_tts_tpu_torch import Inferencer
    serving = dataclasses.replace(config, compute_dtype='float32',
                                  inference_dtype='float32')
    by_path, mels = {}, {}
    noise = torch.randn((len(items), 1024, config.sound.mel_dim),
                        generator=torch.Generator(device=device)
                        .manual_seed(SEED + 250), device=device)
    prior = None
    for route in ROUTES:
        cfg = dataclasses.replace(serving, coupling_backend=route)
        inferencer = Inferencer(state, cfg, device, batch_size=GR_BATCH)
        if prior is None:
            _, prior = prior_of(inferencer, items)
            scale = 960.0 / prior['durations'].sum(dim=1).max().item()
            items = [dict(item, length_scale=scale) for item in items]
            _, prior = prior_of(inferencer, items)
        zero_counts()
        results = inferencer.synthesize_items(items, seed=SEED)
        launches = read_counts()
        assert launches == route_launches(route, cfg, 1), (label, launches)
        for r in results:
            assert r['bucket'] == 1024, r['bucket']
            assert np.isfinite(r['mel']).all(), r['label']
        by_path[f'{label} serve f32 {route}'] = launches
        with torch.no_grad():
            out_k = inferencer.model.inference_decode(
                prior, noise=noise, max_mel_length=1024)
            out_p = inferencer.model.inference_decode(
                prior, noise=noise, max_mel_length=1024, **plain_flow_fns())
        valid = (torch.arange(1024, device=device)[None, :]
                 < out_k['mel_lengths'][:, None])[..., None]
        mae = (((out_k['mels'] - out_p['mels']).abs() * valid).sum()
               / (valid.sum() * noise.shape[-1])).item()
        print(f'{label} served at f32 under {route!r} (B={len(items)}, '
              f'bucket 1024): launches as expected; decode kernel vs plain '
              f'mel MAE {mae:.3e} (bar {MEL_MAE_BOUND:.0e})')
        assert mae < MEL_MAE_BOUND, (label, route, mae)
        mels[route] = out_k['mels']
    assert torch.equal(mels['mega'], mels['fused']), label
    return by_path


# a decoder shape no train build takes (ROADMAP B.2, the train half): a
# WaveNet 256 wide, outside every flow kernel's envelope (ch up to 192)
B2_REFUSED = ((160, 256, 4, 5), {'Decoder': {'Affine_Coupling': {
    'Calc_Channels': 256}}})
# the train paths held to the plain path at full width (label, dtype): one
# step's losses and gradients, then B2_MORE_STEPS more; every other build
# trains one step through its kernels, counted
B2_TRAIN_FULL = (('c200', 'float32'), ('c200', 'bfloat16'),
                 ('c200_pitch', 'bfloat16'), ('c256', 'bfloat16'),
                 ('c100', 'float32'))
B2_MORE_STEPS = 3
B2_TIMED = 3                   # timed calls of #5 and #6, after a warm-up


def check_b2_train_refused(device):
    """A train step at a shape no train build takes (B2_REFUSED) raises
    ROADMAP.md B.2's train-half error on the card before any launch: a
    ValueError from ``flow_stack_train``, caught exactly; nothing falls
    back to the plain version and no library is built."""
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    make_optimizer, make_train_step)
    from glow_tts_tpu_torch.ops.coupling import config_shape
    from glow_tts_tpu_torch.text import Tokenizer
    shape, overrides = B2_REFUSED
    config = shipped_with('Vanilla', overrides)
    assert tuple(config_shape(config)) == shape, config_shape(config)
    batch = batch_to_device(TrainCollater(config, Tokenizer())(
        synthetic_items(config, SEED + 263)), device)
    model = train_model(random_state_dict_of(config), config, device)
    step = make_train_step(config, model,
                           make_optimizer(config, model.parameters()),
                           seed=SEED)
    zero_counts()
    try:
        step(batch)
    except ValueError as err:
        message = str(err)
        assert message.startswith('flow_stack_train: no build of the train '
                                  'kernels'), message
        assert 'ROADMAP.md B.2, the train half' in message, message
    else:
        raise AssertionError(f'{shape}: a train step ran at a shape no '
                             'train build takes')
    counts = read_counts()
    assert not any(value for key, value in counts.items() if key != 'mas'), \
        counts
    print(f'B.2 train step at {shape}: refused on the card before any '
          f'flow launch ({message[:160]}...)')


def b2_train_problem(label, config, state, batch, device):
    """The flow stack's operands of a train step of ``config`` at B.2's
    ``label`` (f32): the squeezed mels and mask, the stacked weights after
    the ActNorm init, and in GR mode the conditioning rows and the pitch
    operand (else None)."""
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    model = train_model(state, config, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              **conditioning_inputs(batch))
    if config.uses_gradient_reversal:
        return pitch_stack_problem(model, batch, config)
    return (*stack_problem(model, batch, config), None, None)


def check_b2_train_kernels(problem, dtype, label):
    """#5 (storing, and not) and #6 of the B.2 build against their plain
    versions on a train step's operands at dropout FLOW_RATE: z, the
    logdet and every gradient of a loss through both (at f32 by
    TRAIN_Z_REL_BOUND, TRAIN_LD_REL_BOUND and GRAD_REL_BOUND of max-abs; at
    bf16 by the bf16 bars, the f32 plain version the reference); the
    dropout masks of a flow step element by element (check_train_forward's
    probe: they are the true 2ch's, which the JAX package draws); the
    stored and the recomputed route bit-equal, and two runs; each timed
    per flow step beside its bound and the plain version.  Returns the
    kernels line's rows of #5 and #6 (launches added by the caller)."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    x, mask, weights, cond, pitch = problem
    bf16 = dtype == BF16
    xd = x.to(dtype)
    s_steps, n, k, ch, ch2 = weights['w_in'].shape
    b, t, c = x.shape
    seed = -20240331
    gen = torch.Generator().manual_seed(SEED + 264)
    dz = torch.randn(x.shape, generator=gen).to(x.device)
    dld = (0.5 + torch.rand(b, generator=gen)).to(x.device)

    def run(fn, at=dtype):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = xd.to(at).detach().clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, cl, pl, seed=seed,
                   dropout_rate=FLOW_RATE)
        torch.autograd.backward((z.float(), ld), (dz, dld))
        torch.cuda.synchronize()
        out = {'z': z.detach().float(), 'ld': ld.detach(),
               'x': xl.grad.float(),
               **{key: leaf.grad for key, leaf in leaves.items()}}
        for key, leaf in (('cond', cl), ('pitch', pl)):
            if leaf is not None:
                out[key] = leaf.grad
        return out

    with torch.no_grad():
        z_fwd, ld_fwd = flow_stack_train(xd, mask, weights, cond, pitch,
                                         seed=seed, dropout_rate=FLOW_RATE)
    stored = [run(forced_route('store')) for _ in range(2)]
    recomputed = run(forced_route('recompute'))
    plain = run(flow_stack_train_reference)
    plain32 = run(flow_stack_train_reference, torch.float32) if bf16 else None
    got = stored[0]
    for key in got:
        assert (stored[1][key] != got[key]).sum().item() == 0, \
            f'{label}: d{key} differs between two runs'
        assert (recomputed[key] != got[key]).sum().item() == 0, \
            f'{label}: d{key} differs between the stored and recomputed route'
    assert (z_fwd.float() != got['z']).sum().item() == 0, \
        f'{label}: the forward without gradient differs from the storing one'
    assert torch.equal(ld_fwd, got['ld'])
    worst = {'z': 0.0, 'grad': 0.0}
    lines = []
    for key, value in plain.items():
        assert torch.isfinite(got[key]).all(), (label, key)
        if not bf16:
            rel = rel_err(got[key], value)
            bar = (TRAIN_Z_REL_BOUND if key == 'z' else TRAIN_LD_REL_BOUND
                   if key == 'ld' else GRAD_REL_BOUND)
            assert rel < bar, (label, key, rel, bar)
            lines.append(f'{key} {rel:.2e}')
        elif key in ('z', 'ld'):
            err, bar = bf16_error(got[key], value, plain32[key])
            assert err <= bar, (label, key, err, bar)
            lines.append(f'{key} {err:.2e} (bar {bar:.2e})')
        elif plain32[key].norm() > 0:
            to_f32 = norm_rel(got[key], plain32[key])
            own = norm_rel(value, plain32[key])
            to_plain = norm_rel(got[key], value)
            assert to_f32 < BF16_GRAD_F32_BAR, (label, key, to_f32)
            assert to_plain <= BF16_GRAD_FACTOR * own + BF16_GRAD_ATOL, (
                label, key, to_plain, own)
            lines.append(f'd{key} {to_plain:.2e} (own {own:.2e})')
        err = (got[key] - value).abs().max().item()
        worst['z' if key in ('z', 'ld') else 'grad'] = max(
            worst['z' if key in ('z', 'ld') else 'grad'], err)

    # the masks, element by element (the true 2ch's at a padded width)
    step, differing, elements, _ = dropout_mask_errors(xd, mask, weights,
                                                       seed, dtype)
    assert differing == 0, (label, differing)

    # per flow step: #5 storing (as a train step runs it) and under no_grad,
    # #6, and the plain version, with the bounds of this run's work
    leaves = {key: value.clone().requires_grad_()
              for key, value in weights.items()}
    xl = xd.detach().clone().requires_grad_()
    cl = None if cond is None else cond.clone().requires_grad_()
    inputs = [xl, *leaves.values()] + ([cl] if cl is not None else [])
    times = {}
    for name, fn, iters in (('kernel', flow_stack_train, B2_TIMED),
                            ('plain', flow_stack_train_reference, 1)):
        def forward():
            return fn(xl, mask, leaves, cl, pitch, seed=SEED,
                      dropout_rate=FLOW_RATE)
        with torch.no_grad():
            no_grad_ms = cuda_ms(forward, iters, 1)
        fwd_ms = cuda_ms(forward, iters, 1)
        z, ld = forward()
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            (z.float(), ld), inputs, (dz, dld), retain_graph=True), iters, 1)
        times[name] = (fwd_ms / s_steps, no_grad_ms / s_steps,
                       bwd_ms / s_steps)
        del z, ld
    per_step = {key: value[0] for key, value in weights.items()}
    valid = mask.sum().item()
    pitch_flops = 0 if pitch is None else 2 * pitch.shape[-1] * ch2 * n
    flops = (step_frame_flops(per_step) + pitch_flops) * valid
    weight_bytes = 4 * sum(value.numel() for value in per_step.values())
    act = 2 if bf16 else 4
    extra = 4 * ((0 if cond is None else cond[0].numel())
                 + (0 if pitch is None else pitch.numel()))
    moved = (2 * act * x.numel() + 4 * (mask.numel() + b) + weight_bytes
             + extra)
    saved_bytes = coupling_grad.saved_bytes_per_step(b * t, c, ch, n, dtype)
    bwd_moved = (saved_bytes + act * x.numel() + 4 * 2 * x.numel()
                 + 2 * weight_bytes + 2 * extra)
    if bf16:
        fwd_bounds = bf16_bounds(moved, flops)
        bwd_bounds = bf16_bounds(bwd_moved, 2 * flops)
    else:
        fwd_bounds = body_bounds(moved, flops)
        ms, by = bound(bwd_moved, 2 * flops, PEAK_TF32_FLOP_PER_S)
        bwd_bounds = {'bound_ms': ms, 'bound_by': by}
    at = 'bf16' if bf16 else 'f32'
    print(f'B.2 {label} #5/#6 {at} vs plain {tuple(x.shape)}, {s_steps} '
          f'steps of {n} layers (k {k}, ch {ch}), rate {FLOW_RATE}, '
          f'{"cond and pitch" if pitch is not None else "no conditioning"}'
          f': ' + ', '.join(lines) + f'; dropout masks of flow step {step}: '
          f'{differing} differing of {elements}; stored and recomputed '
          f'routes bit-equal, two runs bit-equal, the forward without '
          f'gradient bit-equal to the storing one')
    print(f'  per flow step ({int(valid)} valid frames): #5 storing '
          f'{times["kernel"][0]:.4f} ms ({times["kernel"][1]:.4f} under '
          f'no_grad), bound {fwd_bounds["bound_ms"]:.4f} ms by '
          f'{fwd_bounds["bound_by"]}; #6 {times["kernel"][2]:.4f} ms, bound '
          f'{bwd_bounds["bound_ms"]:.4f} ms by {bwd_bounds["bound_by"]}; '
          f'plain forward {times["plain"][0]:.4f} ms, backward '
          f'{times["plain"][2]:.4f} ms; saved '
          f'{saved_bytes / 1e6:.0f} MB a step')
    return ({'max_abs_err': worst['z'], 'ms': times['kernel'][0],
             'no_grad_ms': times['kernel'][1], 'plain_ms': times['plain'][0],
             **fwd_bounds},
            {'max_abs_err': worst['grad'], 'ms': times['kernel'][2],
             'plain_ms': times['plain'][2], **bwd_bounds})


def b2_train_path(config, state, batch, device, label):
    """The train path of ``config`` at B.2's ``label``: the ActNorm init,
    then a train step through the kernels, counted: a #5 launch and
    ``backward_launches_per_step`` #6 kernels a flow step on the build's
    own counters, one MAS, nothing else.  At B2_TRAIN_FULL's builds the
    same init and step also through the plain versions (and at bf16 the
    plain versions at f32, the reference of the bf16 bars), with no
    launch counted, from the same weights, seed and generator state: the
    losses and grad_norm held to them (at f32 TRAIN_LOSS_REL_BOUND and
    TRAIN_NORM_REL_BOUND, at bf16 the bf16 bar), and every gradient of
    the flow decoder (norm-relative: 1e-3 at f32, the bf16 gradient bars);
    then B2_MORE_STEPS more steps through the kernels with finite losses.
    (At bf16 each decoder gradient is held to twice the bf16 plain
    version's own distance from f32, not to the stack's 3e-2 of f32: a
    whole step's weight-norm gradients sit further from f32 than that.)
    Returns the launches by path."""
    from glow_tts_tpu_torch import make_optimizer, make_train_step
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    from glow_tts_tpu_torch.ops.coupling_grad import (
        backward_launches_per_step, flow_stack_train,
        flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    bf16 = config.compute_dtype == 'bfloat16'
    gr = config.uses_gradient_reversal
    full = (label, config.compute_dtype) in B2_TRAIN_FULL
    flows = config.decoder.stack
    n_layers = config.decoder.affine_coupling.wavenet.num_layers
    tag = build_suffix(config, pitch=gr, bf16=bf16)
    expected = {**no_launches(), f'train_fwd{tag}': flows,
                f'train_bwd{tag}': flows * backward_launches_per_step(
                    n_layers, gr), 'mas': 1}
    runs = [('kernels', config, flow_step, flow_stack_train, maximum_path)]
    if full:
        runs.append(('plain', config, flow_step_reference,
                     flow_stack_train_reference, maximum_path_reference))
        if bf16:
            runs.append(('plain f32', dataclasses.replace(
                config, compute_dtype='float32'), flow_step_reference,
                flow_stack_train_reference, maximum_path_reference))
    keys = ['total', 'mle', 'duration'] + (['speaker'] if gr else [])
    results, by_path = {}, {}
    for name, cfg, step_fn, stack_fn, mas_fn in runs:
        model = train_model(state, cfg, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  step_fn=step_fn,
                                  **conditioning_inputs(batch))
        train_step = make_train_step(
            cfg, model, make_optimizer(cfg, model.parameters()), seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED),
            stack_fn=stack_fn, mas_fn=mas_fn)
        zero_counts()
        metrics = train_step(batch)
        counts = read_counts()
        decoder = model.layer_Dict['Decoder']
        grads = {key: p.grad.detach().float().clone()
                 for key, p in decoder.named_parameters()
                 if p.grad is not None}
        if name == 'kernels':
            assert counts == expected, (label, counts)
            by_path[f'B.2 {label} train {cfg.compute_dtype}'] = counts
            more = [train_step(batch) for _ in range(B2_MORE_STEPS if full
                                                     else 0)]
            for m in [metrics, *more]:
                assert all(np.isfinite(v.item()) for v in m.values()), (
                    label, m)
        else:
            assert not any(counts.values()), (label, name, counts)
        results[name] = ({key: metrics[key].item()
                          for key in keys + ['grad_norm']}, grads)
        del model, train_step
    k, k_grads = results['kernels']
    line = (f'B.2 {label} train step at {config.compute_dtype} (B = '
            f'{batch["mels"].shape[0]}, {batch["mels"].shape[1]} frames): '
            + ' '.join(f'{key} {k[key]:.6f}' for key in keys)
            + f' grad_norm {k["grad_norm"]:.5f}; launches '
            + json.dumps({key: v for key, v in expected.items() if v}))
    if not full:
        print(line + ' (kernels only)')
        return by_path
    p, p_grads = results['plain']
    worst = 0.0
    if bf16:
        p32, p32_grads = results['plain f32']
        vec = {name: torch.tensor([r[0][key] for key in keys],
                                  dtype=torch.float64)
               for name, r in results.items()}
        err, bar = bf16_error(vec['kernels'], vec['plain'], vec['plain f32'])
        assert err <= bar, (label, err, bar)
        # a whole step's parameter gradients at bf16 (weight norm's g
        # among them) sit further from f32 than the stack's gradients: each
        # is held to twice the bf16 plain version's own distance from f32
        worst_own = 0.0
        for key, value in k_grads.items():
            if p32_grads[key].norm() == 0:
                continue
            own = norm_rel(p_grads[key], p32_grads[key])
            to_plain = norm_rel(value, p_grads[key])
            assert to_plain <= BF16_GRAD_FACTOR * own + BF16_GRAD_ATOL, (
                label, key, to_plain, own)
            worst, worst_own = max(worst, to_plain), max(worst_own, own)
        line += (f'; losses vs bf16 plain max abs err {err:.3e} (bar '
                 f'{bar:.3e}); decoder gradients norm-rel to bf16 plain at '
                 f'most {worst:.3e} (bf16 plain to f32 plain at most '
                 f'{worst_own:.3e})')
    else:
        for key in keys + ['grad_norm']:
            bar = (TRAIN_NORM_REL_BOUND if key == 'grad_norm'
                   else TRAIN_LOSS_REL_BOUND)
            assert abs(k[key] - p[key]) <= bar * abs(p[key]), (label, key,
                                                               k, p)
        for key, value in k_grads.items():
            if p_grads[key].norm() == 0:
                assert value.norm() == 0, (label, key)
                continue
            rel = norm_rel(value, p_grads[key])
            assert rel < TRAIN_NORM_REL_BOUND, (label, key, rel)
            worst = max(worst, rel)
        line += ('; plain ' + ' '.join(f'{key} {p[key]:.6f}' for key in keys)
                 + f' grad_norm {p["grad_norm"]:.5f}; decoder gradients '
                 f'norm-rel at most {worst:.3e} (bar '
                 f'{TRAIN_NORM_REL_BOUND:.0e})')
    print(line + f'; then {B2_MORE_STEPS} more steps, losses finite')
    return by_path


def random_state_dict_of(config):
    from glow_tts_tpu_torch import random_state_dict
    return random_state_dict(dataclasses.replace(
        config, compute_dtype='float32'), SEED + 260)


def run_b2_shapes_phase(card, device=None):
    """Every flow kernel at decoder shapes besides the shipped two
    (ROADMAP B.2), each build at f32 and bf16 (B2_SHAPES; B2_SOURCES where
    a build runs less).  The deterministic ones (#3, #2, #4): each against
    its plain version at B = 32 x T_f = 512, all frames valid and on the
    eval batch's ragged mask, both directions, #4 bit-equal to 12 chained
    #3 launches, #2 bf16 bit-equal to #3 bf16 on an identity ActNorm and
    mixing, each timed (by CUDA graph at the decode shape) beside its
    bound; the ActNorm init and one eval step at B = 32 x 224 tokens x
    1024 frames under each route (B2_ROUTES where fewer; counted).  The
    train pair (#5, #6): against their plain versions on the train batch's
    operands (check_b2_train_kernels), and a train step through them
    (counted; b2_train_path).  At B2_FULL's builds (100-bin mels at
    Num_Squeeze 2 and 1, 128-bin mels at 2; the shipped WaveNet) the init
    and eval are held to the plain versions (loss bars), the train steps of
    B2_TRAIN_FULL too, and an Inferencer serves B = 32 in the 1024 bucket
    under each route at f32 and bf16; a train step at a shape no train
    build takes raises B.2's error.  Returns the kernels line's rows (by
    build and dtype) and the launches by path."""
    from glow_tts_tpu_torch import TrainCollater, batch_to_device
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops.coupling import config_shape
    from glow_tts_tpu_torch.text import Tokenizer, text_filtering
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    device = device or torch.device('cuda', 0)
    start = time.perf_counter()
    rows, by_path, seconds = {}, {}, {}
    for label, (shape, ps) in B2_SHAPES.items():
        begun = time.perf_counter()
        f32 = b2_config(label)
        assert tuple(config_shape(f32)) == shape, (label, config_shape(f32))
        gr = f32.uses_gradient_reversal
        assert (f32.decoder.num_squeeze if gr else 0) == ps, label
        builds = b2_builds(label)
        state = random_state_dict_of(f32)
        batch = (conditioned_batch(f32, device, SEED + 261) if gr else
                 batch_to_device(TrainCollater(f32, Tokenizer())(
                     synthetic_items(f32, SEED + 262)), device))
        model = fresh_model(state, f32, device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                                  **conditioning_inputs(batch))
        _, eval_mask = squeeze(batch['mels'], sequence_mask(
            batch['mel_lengths'], batch['mels'].shape[1]),
            f32.decoder.num_squeeze)
        full = label in B2_FULL
        for dtype in (torch.float32, BF16):
            at = 'bfloat16' if dtype == BF16 else 'float32'
            if at not in builds['flow_step']:
                continue
            tag = ('_bf16_' if dtype == BF16 else '_') + label
            for name, row in flow_kernel_rows(
                    model, device, eval_mask, f'B.2 {label} {at}', dtype,
                    pitch=gr, names=tuple(
                        name for name in ('flow_step', 'coupling',
                                          'flow_stack')
                        if at in builds.get(name, ())),
                    iters=B2_KERNEL_ITERS, graph=True).items():
                rows[name + tag] = row
            config = dataclasses.replace(f32, compute_dtype=at)
            paths, _ = routes_eval(config, state, batch, device,
                                   f'B.2 {label} {at}', 1,
                                   routes=B2_ROUTES.get(label, tuple(ROUTES)),
                                   plain=full)
            by_path.update(paths)
        del model
        # the train pair: against the plain versions on a train step's
        # operands, then a train step through it (counted), at each dtype
        problem = b2_train_problem(label, f32, state, batch, device)
        for dtype in (torch.float32, BF16):
            at = 'bfloat16' if dtype == BF16 else 'float32'
            if at not in builds['train_fwd']:
                continue
            tag = ('_bf16_' if dtype == BF16 else '_') + label
            fwd_row, bwd_row = check_b2_train_kernels(problem, dtype, label)
            rows['flow_train_fwd' + tag] = fwd_row
            rows['flow_train_bwd' + tag] = bwd_row
            by_path.update(b2_train_path(dataclasses.replace(
                f32, compute_dtype=at), state, batch, device, label))
        del problem
        if full:
            items = [{'label': f'v{i}',
                      'text': text_filtering(INFERENCE_TEXTS[i % 4])}
                     for i in range(GR_BATCH)]
            by_path.update(serve_b2_f32(f32, state, items, device,
                                        f'B.2 {label}'))
            by_path.update(serve_bf16_routes(f32, state, items, device,
                                             f'B.2 {label}'))
        seconds[label] = round(time.perf_counter() - begun, 1)
    check_b2_train_refused(device)
    print('B.2 shapes phase: ' + json.dumps({
        'seconds_by_build': seconds,
        'seconds': round(time.perf_counter() - start, 1), 'card': card}))
    return rows, by_path


DP_STEPS = 3                   # train steps of the NCCL run
DP_TIMED = 3                   # steps a timing takes, after one warm-up
DP_GLOO_RANKS = 2              # two ranks on the one card, over gloo
DP_TIMEOUT = 600               # seconds a sub-run may take in all
# the train path's bars (tests/test_torch_train_step.py), held by the
# ranks' step against one process's on the global batch
DP_LOSS_RTOL, DP_NORM_RTOL = 2e-5, 2e-4
DP_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DP_PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
DP_LOSS_KEYS = ('total', 'mle', 'duration')


def without_dropout(config):
    """``config`` (the port's) with every dropout rate 0."""
    rep = dataclasses.replace
    enc, dec = config.encoder, config.decoder
    enc = rep(enc, prenet=rep(enc.prenet, dropout_rate=0.0),
              transformer=rep(enc.transformer, dropout_rate=0.0),
              duration_predictor=rep(enc.duration_predictor,
                                     dropout_rate=0.0))
    coupling = dec.affine_coupling
    coupling = rep(coupling, wavenet=rep(coupling.wavenet, dropout_rate=0.0))
    return rep(config, encoder=enc,
               decoder=rep(dec, affine_coupling=coupling))


def dp_train_launches(config, steps):
    """The kernels ``steps`` Vanilla train steps of ``config`` launch on
    one rank: #1 once, #5 per flow step and #6's kernels per flow step, of
    the build of its width and dtype."""
    flows = config.decoder.stack
    tag = build_suffix(config, bf16=config.compute_dtype == 'bfloat16')
    return {**no_launches(), 'mas': steps,
            f'train_fwd{tag}': flows * steps,
            f'train_bwd{tag}': BWD_KERNELS_PER_FLOW_STEP * flows * steps}


def dp_trainee(state, config, batch, device):
    """A model as training holds it, ActNorm initialised on ``batch`` (the
    global batch, as every rank of a ``Trainer`` does)."""
    model = train_model(state, config, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'])
    return model


def dp_step(config, model, world, em=False, device=None):
    """``(step, gradients)``: a train step of ``model`` under ``world``,
    seed ``SEED`` (the encoder's generator ``shard_seed(SEED, rank)``, so
    SEED on rank 0), and a list that takes the first update's summed
    gradients, by name (with ``em``: the 'em' warmup with the decoder
    frozen, its statistics in ``step.em``)."""
    from glow_tts_tpu_torch import EMState, init_em_stats, make_optimizer
    from glow_tts_tpu_torch import make_train_step
    optimizer = make_optimizer(config, model.parameters())
    names = {id(p): name for name, p in model.named_parameters()}
    grads, update = [], optimizer.step

    def recording(frozen=()):
        if not grads:
            grads.append({names[id(p)]: p.grad.detach().clone()
                          for p in optimizer.params})
        return update(frozen)

    optimizer.step = recording
    holder = EMState(init_em_stats(config, device)) if em else None
    step = make_train_step(config, model, optimizer, seed=SEED,
                           em_alignment=em, freeze_decoder=em,
                           em_state=holder, world=world)
    step.em = holder
    return step, grads


def dp_values(metrics):
    return {key: value.item() for key, value in metrics.items()}


def dp_compare(got, ref, what):
    """The ranks' metrics against one process's, to the train path's
    bars; returns the worst relative error."""
    worst = 0.0
    for key in ref:
        rtol = DP_NORM_RTOL if key == 'grad_norm' else DP_LOSS_RTOL
        err = abs(got[key] - ref[key]) / max(abs(ref[key]), 1e-30)
        assert np.isfinite(got[key]) and err <= rtol, (what, key, got, ref)
        worst = max(worst, err)
    return worst


def dp_ratio(got, ref, tol):
    """Tensors by name against ``ref``'s: the worst ``|a - b| / (atol +
    rtol |b|)`` (at most 1 within the bar)."""
    assert set(got) == set(ref)
    return max(((got[n].double() - ref[n].double()).abs()
                / (tol['atol'] + tol['rtol'] * ref[n].double().abs())
                ).max().item() for n in ref)


def dp_nccl_rank(config16):
    """Every card over NCCL: ``DP_STEPS`` steps of this rank's rows of the
    global batch; on rank 0 the same steps of one process on the whole
    batch from the same weights, seed and generator; then both timed.  In
    a world of one the shipped YAML as shipped (bf16, dropout on), held
    bit for bit; on more cards each rank draws its own dropout and rounds
    its bf16 gradients before the sum (``PERF.md``, PR 16), so there the
    YAML runs at f32 with every dropout rate 0, held to the train path's
    bars."""
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    make_optimizer, make_train_step,
                                    random_state_dict)
    from glow_tts_tpu_torch.parallel import data as pdata
    from glow_tts_tpu_torch.text import Tokenizer
    world = pdata.initialize(config16, 'cuda')
    assert world.backend == 'nccl', world
    device = world.device
    config = config16 if world.size == 1 else without_dropout(
        dataclasses.replace(config16, compute_dtype='float32'))
    whole = batch_to_device(TrainCollater(config, Tokenizer())(
        synthetic_items(config, SEED + 10)), device)
    share = EVAL_BATCH // world.size
    mine = {key: value[world.rank * share:(world.rank + 1) * share]
            for key, value in whole.items()}
    state = random_state_dict(config, SEED)
    out = {'rank': world.rank, 'world_size': world.size,
           'device': str(device), 'backend': world.backend,
           'compute_dtype': config.compute_dtype}
    if world.is_main:
        one = dp_trainee(state, config, whole, device)
        one_step = make_train_step(
            config, one, make_optimizer(config, one.parameters()),
            seed=SEED,
            generator=torch.Generator(device=device).manual_seed(SEED))
        ref = [dp_values(one_step(whole)) for _ in range(DP_STEPS)]
        ref_params = {k: v.clone() for k, v in one.state_dict().items()}
    model = dp_trainee(state, config, whole, device)
    step, _ = dp_step(config, model, world)
    zero_counts()
    got = [dp_values(step(mine)) for _ in range(DP_STEPS)]
    out['launches'] = read_counts()
    assert out['launches'] == dp_train_launches(config, DP_STEPS), \
        out['launches']
    out['metrics'] = got
    if world.is_main:
        out['single_process_metrics'] = ref
        params = model.state_dict()
        if world.size == 1:
            # every reduction is an identity: the same bits
            assert got == ref, (got, ref)
            for key, value in ref_params.items():
                assert torch.equal(params[key], value), key
            out['bit_equal'] = True
        else:
            out['worst_loss_rel_err'] = max(
                dp_compare(g, r, 'nccl') for g, r in zip(got, ref))
            out['worst_param_ratio'] = dp_ratio(params, ref_params,
                                                DP_PARAM_TOL)
            assert out['worst_param_ratio'] <= 1.0, out
        dp_ms, one_ms = paired_ms(lambda: step(mine),
                                  lambda: one_step(whole), iters=DP_TIMED,
                                  plain_warmup=1)
        out.update(step_ms=dp_ms, single_process_step_ms=one_ms)
    else:
        # in step with rank 0's two timings of this rank's step
        out['step_ms'] = (cuda_ms(lambda: step(mine), DP_TIMED)
                          + cuda_ms(lambda: step(mine), DP_TIMED)) / 2
    return out


def dp_table(step):
    """A copy of the 'em' table statistics ``step`` holds (None outside
    the 'em' warmup)."""
    return None if step.em is None else [t.clone() for t in step.em.stats]


def dp_gloo_case(world, config16, items, device, em=False):
    """One step of this rank's own collation of its half of ``items``
    under ``world`` and, on rank 0, of one process on all of them, from
    the same weights, at f32 and at bf16 (``config16`` as shipped).  At
    f32 the metrics and the summed gradients (with ``em`` also the table)
    are held to the train path's bars; at bf16 the metrics and the table
    too, and the gradients, whose bf16 roundings move with the batch's
    split, to the bf16 bar: each tensor no further from one process's at
    bf16 than twice that one's distance from f32, plus 1e-4 (norm-
    relative; the JAX package's 2-way mesh moves its bf16 gradients by
    the same order, ``tests/test_torch_data_parallel.py``).  On rank 0 a control: one process at bf16 on the same
    batch with the mel axis padded to another bucket, its gradients'
    distance printed.  The rank's bf16 step then timed by CUDA events."""
    from glow_tts_tpu_torch import TrainCollater, batch_to_device
    from glow_tts_tpu_torch import random_state_dict
    from glow_tts_tpu_torch.parallel.data import SINGLE
    from glow_tts_tpu_torch.text import Tokenizer, load_token_dict
    token_dict = (load_token_dict(config16.token_path)
                  if os.path.exists(config16.token_path) else None)
    tokenizer = Tokenizer(token_dict)
    half = len(items) // world.size
    out, one, dp = {}, {}, {}
    for dtype in ('float32', 'bfloat16'):
        config = dataclasses.replace(config16, compute_dtype=dtype)
        collate = TrainCollater(config, tokenizer)
        whole = batch_to_device(collate(items), device)
        mine = batch_to_device(collate(
            items[world.rank * half:(world.rank + 1) * half]), device)
        state = random_state_dict(config, SEED)
        if world.is_main:
            one_step, grads = dp_step(
                config, dp_trainee(state, config, whole, device), SINGLE, em,
                device)
            one[dtype] = (dp_values(one_step(whole)), grads[0],
                          dp_table(one_step))
        step, grads = dp_step(config, dp_trainee(state, config, whole,
                                                 device), world, em, device)
        zero_counts()
        got = dp_values(step(mine))
        out[dtype] = {'launches': read_counts(), 'metrics': got,
                      'shape': list(mine['mels'].shape),
                      'single_process_shape': list(whole['mels'].shape)}
        dp[dtype] = (got, grads[0], dp_table(step))
    out['launches'] = out['bfloat16']['launches']
    out['step_ms'] = cuda_ms(lambda: step(mine), DP_TIMED, warmup=1)
    if not world.is_main:
        return out
    for dtype in ('float32', 'bfloat16'):
        (got, grads, table), (ref, ref_grads, ref_table) = (dp[dtype],
                                                            one[dtype])
        row = out[dtype]
        row['single_process_metrics'] = ref
        row['worst_loss_rel_err'] = dp_compare(got, ref, f'gloo {dtype}')
        # the train path's elementwise bar, held at f32
        row['worst_grad_ratio'] = dp_ratio(grads, ref_grads, DP_GRAD_TOL)
        if dtype == 'float32':
            assert row['worst_grad_ratio'] <= 1.0, row
        else:
            f32_grads = one['float32'][1]
            worst = 0.0
            for name, want in ref_grads.items():
                err = norm_rel(grads[name], want)
                bar = (BF16_GRAD_FACTOR * norm_rel(want, f32_grads[name])
                       + BF16_GRAD_ATOL)
                assert err <= bar, ('gloo bf16 gradients', name, err, bar)
                worst = max(worst, err / bar)
            row['worst_grad_bar_share'] = worst
        if em:
            assert ref_table[0].sum() > 0
            # frames whose token id the step's MAS paths gave otherwise
            row['em_frames_moved'] = (table[0] - ref_table[0]).abs(
                ).sum().item() / 2
            row['em_stats_rel_err'] = max(
                rel_err(a, b) for a, b in zip(table[1:], ref_table[1:]))
            # at either dtype the table of one process: the same frames
            # under each token, the sums to EM_STATS_REL_BOUND
            assert row['em_frames_moved'] == 0, row
            assert row['em_stats_rel_err'] <= EM_STATS_REL_BOUND, row
    # the control: the same samples in one process, only the mel axis
    # padded otherwise, at bf16
    config = dataclasses.replace(config16, mel_bucket=3 * config16.mel_bucket)
    whole = batch_to_device(TrainCollater(config, tokenizer)(items), device)
    control, grads = dp_step(config, dp_trainee(
        random_state_dict(config, SEED), config, whole, device), SINGLE, em,
        device)
    control(whole)
    ref_grads = one['bfloat16'][1]
    out['control'] = {
        'shape': list(whole['mels'].shape),
        'em_frames_moved': (control.em.stats[0] - one['bfloat16'][2][0]
                            ).abs().sum().item() / 2 if em else None,
        'worst_grad_norm_rel': max(norm_rel(grads[0][n], ref_grads[n])
                                   for n in ref_grads),
        'worst_grad_ratio': dp_ratio(grads[0], ref_grads, DP_GRAD_TOL)}
    return out


def dp_gloo_rank(config16):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    card), every dropout rate 0, each on its own collation of half the
    batch: the shipped YAML's step at B = 16 a rank against one process at
    B = 32 on the same samples, and one 'em' step at MiniSpeech's config."""
    import tempfile
    from glow_tts_tpu_torch.parallel import data as pdata
    world = pdata.initialize(config16, 'cuda', backend='gloo')
    assert (world.backend, world.device) == ('gloo', torch.device('cuda', 0))
    out = {'rank': world.rank, 'world_size': world.size,
           'device': str(world.device), 'backend': world.backend}
    config = without_dropout(config16)
    out['vanilla'] = dp_gloo_case(world, config,
                                  synthetic_items(config, SEED + 10),
                                  world.device)
    assert out['vanilla']['launches'] == dp_train_launches(config16, 1), \
        out
    root = tempfile.mkdtemp(prefix='chip_smoke_dp_')
    ms = without_dropout(minispeech_config(root, 'bfloat16'))
    out['em'] = dp_gloo_case(world, ms, minispeech_items(MS_BATCH, SEED + 92),
                             world.device, em=True)
    return out


def data_parallel_rank(kind, out_path):
    """One rank of a sub-run of the data-parallel phase."""
    from glow_tts_tpu_torch import load_config
    from glow_tts_tpu_torch.parallel import data as pdata
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as Trainer sets it for the process
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    config16 = load_config(CONFIG)
    assert config16.compute_dtype == 'bfloat16'
    result = {'nccl': dp_nccl_rank, 'gloo': dp_gloo_rank,
              'tp': tp_gloo_rank, 'serve': dp_serve_rank}[kind](config16)
    with open(out_path, 'w', encoding='utf-8') as f:
        json.dump(result, f)
    pdata.close()


def launch_ranks(kind, ranks, local_ranks, root):
    """Run ``ranks`` processes of :func:`data_parallel_rank` with
    torchrun's environment, rank r on card ``local_ranks[r]``; wait for
    all (killing them after ``DP_TIMEOUT``) and return their results, or
    fail with their output."""
    import socket
    with socket.socket() as probe:
        probe.bind(('localhost', 0))
        port = probe.getsockname()[1]
    procs, logs = [], []
    start = time.perf_counter()
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(local_ranks[rank]),
                   LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR='localhost',
                   MASTER_PORT=str(port))
        logs.append(os.path.join(root, f'{kind}-{rank}.log'))
        with open(logs[-1], 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 '--data-parallel-rank', kind,
                 os.path.join(root, f'{kind}-{rank}.json')],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=max(DP_TIMEOUT - (time.perf_counter()
                                                - start), 1))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [rank for rank, proc in enumerate(procs) if proc.returncode]
    for rank in failed:
        with open(logs[rank], encoding='utf-8') as f:
            print(f'{kind} rank {rank} failed:\n{f.read()[-6000:]}')
    assert not failed, f'{kind}: ranks {failed} failed'
    results = []
    for rank in range(ranks):
        with open(os.path.join(root, f'{kind}-{rank}.json'),
                  encoding='utf-8') as f:
            results.append(json.load(f))
    return results, time.perf_counter() - start


def run_data_parallel_phase(card):
    """The shipped YAML, Vanilla, at the global B = 32 training shape and
    bf16 as shipped, one process per rank: (1) every card over NCCL, 3
    steps, bit-equal to one process in a world of one; (2) two ranks on
    card 0 over gloo at B = 16 each from its own collation, dropout 0,
    against one process at B = 32, and the same for one 'em' step at
    MiniSpeech's config.  Prints each rank's launches of #1, #5 and #6 and
    the step times; returns the launches by path."""
    import tempfile
    root = tempfile.mkdtemp(prefix='chip_smoke_dp_runs_')
    torch.cuda.empty_cache()       # this process's cache, for the ranks
    cards = torch.cuda.device_count()
    nccl, nccl_s = launch_ranks('nccl', cards, list(range(cards)), root)
    gloo, gloo_s = launch_ranks('gloo', DP_GLOO_RANKS, [0] * DP_GLOO_RANKS,
                                root)
    by_path = {}
    counted = ('mas', 'train_fwd', 'train_bwd', 'train_fwd_bf16',
               'train_bwd_bf16', 'train_fwd_bf16_c80', 'train_bwd_bf16_c80',
               'train_fwd_c80', 'train_bwd_c80')
    for kind, results in (('nccl', nccl), ('gloo', gloo)):
        for result in results:
            runs = ([('', result)] if kind == 'nccl' else
                    [(f' {case} {dtype}', result[case][dtype])
                     for case in ('vanilla', 'em')
                     for dtype in ('float32', 'bfloat16')])
            for label, part in runs:
                launches = part['launches']
                by_path[f'data parallel {kind}{label} rank '
                        f'{result["rank"]}'] = launches
                print(f'data parallel {kind}{label}: rank {result["rank"]} '
                      f'of {result["world_size"]} on {result["device"]} '
                      f'({result["backend"]}): launches ' + ', '.join(
                          f'{k} {launches[k]}' for k in counted
                          if launches.get(k)))
    main = nccl[0]
    print(f'data parallel nccl: {main["world_size"]} rank(s), {DP_STEPS} '
          f'steps of the shipped YAML at {main["compute_dtype"]}, B = '
          f'{EVAL_BATCH} in all: '
          + ('bit-equal to one process (losses and weights)'
             if main.get('bit_equal') else
             f'losses within {main["worst_loss_rel_err"]:.2e} of one '
             f'process (bar {DP_LOSS_RTOL}), weights at '
             f'{main["worst_param_ratio"]:.3f} of their bar')
          + f'; step {main["step_ms"]:.3f} ms against one process\'s '
          f'{main["single_process_step_ms"]:.3f} ms by CUDA events '
          f'({card}); {nccl_s:.1f} s')
    for case in ('vanilla', 'em'):
        part = gloo[0][case]
        for dtype in ('float32', 'bfloat16'):
            row = part[dtype]
            print(f'data parallel gloo {case} {dtype}: {DP_GLOO_RANKS} ranks '
                  f'on card 0, each on its own collation {row["shape"]}, '
                  f'against one process on {row["single_process_shape"]}: '
                  f'losses within {row["worst_loss_rel_err"]:.2e} (bar '
                  f'{DP_LOSS_RTOL}, grad_norm {DP_NORM_RTOL}); gradients at '
                  f'{row["worst_grad_ratio"]:.3f} of the train path\'s bar '
                  f'(rtol {DP_GRAD_TOL["rtol"]}, atol {DP_GRAD_TOL["atol"]})'
                  + (' (held)' if dtype == 'float32' else
                     f' (not held at bf16: {row["worst_grad_bar_share"]:.3f} '
                     f'of the bf16 bar, held)')
                  + ('' if case != 'em' else
                     f'; em_stats {row["em_stats_rel_err"]:.2e}, '
                     f'{row["em_frames_moved"]:.0f} frames of another token '
                     f'(bar {EM_STATS_REL_BOUND}, 0 frames)'))
        control = part['control']
        print(f'data parallel gloo {case} control: one process at bf16 on '
              f'the same samples padded to {control["shape"]}: gradients '
              f'{control["worst_grad_norm_rel"]:.2e} norm-relative from '
              f'those on {part["bfloat16"]["single_process_shape"]}, '
              f'{control["worst_grad_ratio"]:.3f} of the train path\'s bar'
              + (f', {control["em_frames_moved"]:.0f} frames of another '
                 f'token in the EM table' if case == 'em' else ''))
        print(f'data parallel gloo {case}: a rank\'s bf16 step '
              + ', '.join(f'{r[case]["step_ms"]:.3f}' for r in gloo)
              + f' ms by CUDA events ({card})')
    print(f'data parallel phase: {nccl_s:.1f} s for the NCCL run, '
          f'{gloo_s:.1f} s for the gloo run')
    print('data parallel: ' + json.dumps({
        'nccl': [{k: r[k] for k in ('rank', 'world_size', 'step_ms')}
                 for r in nccl],
        'nccl_single_process_step_ms': main['single_process_step_ms'],
        'gloo_step_ms': [{case: r[case]['step_ms']
                          for case in ('vanilla', 'em')} for r in gloo],
        'card': card}))
    return by_path


# ---------------------------------------------------------------------------
# tensor parallelism: two ranks on card 0 over gloo as one model group
# ---------------------------------------------------------------------------

TP_RANKS = 2                   # data 1 × model 2, both ranks on card 0
TP_BATCH, TP_TOKENS, TP_FRAMES = 8, 220, 512   # texts padded to 224 tokens
TP_STEPS = 2                   # train steps held against one process
TP_TIMED = 2                   # steps a timing takes, after one warm-up
TP_LOSS_RTOL = TP_NORM_RTOL = 2e-4             # tests/test_tp.py's bars
TP_PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
TP_EVAL_TOL = dict(rtol=5e-5, atol=1e-6)


def tp_items(config, seed):
    """``TP_BATCH`` seeded items: texts of 10 … ``TP_TOKENS`` tokens and
    mels of 64 … ``TP_FRAMES`` frames."""
    rng = np.random.default_rng(seed)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    items = []
    for n_tok, n_mel in zip(np.linspace(10, TP_TOKENS, TP_BATCH).round(),
                            np.linspace(64, TP_FRAMES, TP_BATCH).round()):
        chars = rng.choice(letters, int(n_tok) - 2)          # + <S>, <E>
        chars[5::6] = ' '
        a = config.sound.max_abs_mel
        mel = rng.uniform(-a, a, (int(n_mel), config.sound.mel_dim))
        items.append({'text': ''.join(chars), 'mel': mel.astype(np.float32)})
    return items


def tp_model(state, config, world, train):
    """A model of ``state`` sharded over ``world``'s model group (whole in
    a world of one) on its device: weight norm unfolded to train, folded
    to serve."""
    from glow_tts_tpu_torch import build_model
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.weights import load_state_dict
    model = load_state_dict(build_model(config), state).to(world.device)
    return tp.shard_model(model, world).prepare(fold=not train)


def tp_train(config, model, world, batch):
    """``TP_STEPS`` train steps of ``model`` under ``world``, seed
    ``SEED``: the step, its metrics, the first update's gradients by name,
    the MAS paths, and the model group's collectives of the first step."""
    from glow_tts_tpu_torch import make_optimizer, make_train_step
    from glow_tts_tpu_torch.ops.mas import maximum_path
    from glow_tts_tpu_torch.parallel import tp
    optimizer = make_optimizer(config, model.parameters())
    names = {id(p): name for name, p in model.named_parameters()}
    grads, paths, update = [], [], optimizer.step

    def recording(frozen=()):
        if not grads:
            grads.append({names[id(p)]: p.grad.detach().clone()
                          for p in optimizer.params})
        return update(frozen)

    def mas(*args):
        paths.append(maximum_path(*args))
        return paths[-1]

    optimizer.step = recording
    step = make_train_step(
        config, model, optimizer, seed=SEED, mas_fn=mas, world=world,
        generator=torch.Generator(device=world.device).manual_seed(SEED))
    tp.reset_collectives()
    metrics = [dp_values(step(batch))]
    collectives = dict(tp.COLLECTIVES)
    metrics += [dp_values(step(batch)) for _ in range(TP_STEPS - 1)]
    return step, metrics, grads[0], paths, collectives


def tp_serve(model, world, batch, noise, durations=None):
    """The eval step's losses, the prior, and one decode in the
    ``TP_FRAMES`` bucket from ``noise`` (from the durations given, where
    they are), under ``world``."""
    from glow_tts_tpu_torch import make_eval_step
    losses, _ = make_eval_step(model.config, model, world=world)(batch)
    prior = model.inference_prior(batch['tokens'], batch['token_lengths'])
    given = prior if durations is None else {**prior,
                                             'durations': durations}
    out = model.inference_decode(given, noise=noise,
                                 max_mel_length=TP_FRAMES)
    return dp_values(losses), prior, out


def tp_same_on_every_rank(world, tensors):
    """The elements in which this model group's ranks differ, over the
    float32 ``tensors`` concatenated (0: bit-equal)."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors]).cpu()
    copies = world.gather_bytes(flat.view(torch.uint8))
    return sum(int((copy.view(torch.float32) != flat).sum())
               for copy in copies)


def tp_gloo_rank(config16):
    """Two ranks on card 0 over gloo as one model group (data 1 × model 2)
    at the shipped YAML's widths, B = ``TP_BATCH``: at f32 and at bf16,
    ``TP_STEPS`` train steps, an eval step and a decode in the
    ``TP_FRAMES`` bucket, held on rank 0 against one process on the same
    card (the kernels' routes), same weights, batch, seeds and noise; the
    replicated gradients and the MAS paths bit-equal across the ranks;
    each rank's step timed, and one process's beside it."""
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    random_state_dict)
    from glow_tts_tpu_torch.parallel import data as pdata
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.text import Tokenizer, load_token_dict
    shipped = dataclasses.replace(config16, data_parallel=1,
                                  model_parallel=TP_RANKS)
    world = pdata.initialize(shipped, 'cuda', backend='gloo')
    assert (world.backend, world.device, world.model_size) == (
        'gloo', torch.device('cuda', 0), TP_RANKS), world
    device = world.device
    token_dict = (load_token_dict(config16.token_path)
                  if os.path.exists(config16.token_path) else None)
    out = {'rank': world.rank, 'world_size': world.size,
           'device': str(device), 'backend': world.backend}
    single = dataclasses.replace(pdata.SINGLE, device=device)
    one = {}
    for dtype in ('float32', 'bfloat16'):
        config = dataclasses.replace(shipped, compute_dtype=dtype)
        alone = dataclasses.replace(config, data_parallel=0,
                                    model_parallel=1)
        batch = batch_to_device(TrainCollater(config, Tokenizer(token_dict))(
            tp_items(config, SEED + 30)), device)
        state = random_state_dict(config, SEED)
        noise = torch.randn(
            (TP_BATCH, TP_FRAMES, config.sound.mel_dim), device=device,
            generator=torch.Generator(device=device).manual_seed(SEED + 3))
        row = {'shape': list(batch['mels'].shape),
               'tokens': list(batch['tokens'].shape)}
        if world.is_main:
            # one process on the same card, through the kernels
            model = tp_model(state, alone, single, train=True)
            step, metrics, grads, _, _ = tp_train(alone, model, single,
                                                  batch)
            served = tp_serve(tp_model(state, alone, single, False), single,
                              batch, noise)
            one[dtype] = {'step': step, 'metrics': metrics, 'grads': grads,
                          'params': {k: v.clone() for k, v in
                                     model.state_dict().items()},
                          'losses': served[0], 'prior': served[1],
                          'mels': served[2]['mels'],
                          'mel_lengths': served[2]['mel_lengths']}
            durations = served[1]['durations'].cpu()
        else:
            durations = torch.empty((TP_BATCH, batch['tokens'].shape[1]))
        # every rank decodes from the world of one's durations: the same as
        # its own but where a ceil flips at an edge (below)
        torch.distributed.broadcast(durations, 0, group=world.host_group)
        model = tp_model(state, config, world, train=True)
        sharded, total = tp.sharded_param_count(model.tp_specs,
                                                model.tp_shapes)
        zero_counts()
        step, metrics, grads, paths, collectives = tp_train(config, model,
                                                            world, batch)
        losses, prior, decoded = tp_serve(
            tp_model(state, config, world, False), world, batch, noise,
            durations.to(device))
        row['launches'] = read_counts()
        assert row['launches'] == {**no_launches(),
                                   'mas': TP_STEPS + 1}, row['launches']
        replicated = [name for name, dim in model.tp_specs.items()
                      if dim is None]
        row.update(
            metrics=metrics, collectives=collectives,
            sharded_share=sharded / total,
            replicated_grads_differing=tp_same_on_every_rank(
                world, [grads[name] for name in replicated]),
            paths_differing=tp_same_on_every_rank(world, paths))
        assert row['sharded_share'] > 0.3, row
        assert row['replicated_grads_differing'] == 0, row
        assert row['paths_differing'] == 0, row
        params = tp.full_state_dict(model, world)
        if world.is_main:
            ref = one[dtype]
            # the row-parallel duration predictor sums in another order:
            # its log-durations to the eval bar (f32) or the bf16 bar; a
            # ceil of two durations that close may still flip, by one
            log_d, ref_log_d = (p['log_durations'][..., 0].float()
                                for p in (prior, ref['prior']))
            row['log_duration_max_abs'] = (log_d - ref_log_d).abs().max(
                ).item()
            if dtype == 'float32':
                assert torch.allclose(log_d, ref_log_d,
                                      **TP_EVAL_TOL), row
            else:
                f32_log_d = one['float32']['prior']['log_durations'][
                    ..., 0].float()
                assert row['log_duration_max_abs'] <= BF16_FACTOR * (
                    ref_log_d - f32_log_d).abs().max().item() + BF16_ATOL, \
                    row
            apart = (prior['durations'] - ref['prior']['durations']).abs()
            row['durations_flipped'] = int((apart > 0).sum())
            row['durations_valid'] = int(batch['token_lengths'].sum())
            assert apart.max().item() <= 1, row
            assert torch.equal(decoded['mel_lengths'], ref['mel_lengths'])
            valid = (torch.arange(TP_FRAMES, device=device)[None, :]
                     < ref['mel_lengths'][:, None])[..., None]
            mel_err = (decoded['mels'] - ref['mels']).abs() * valid
            row['mel_mae'] = (mel_err.sum() / (valid.sum()
                              * config.sound.mel_dim)).item()
            row['mel_max_abs'] = mel_err.max().item()
            specs = model.tp_specs
            mine = tp.shard_state_dict(ref['grads'], world, specs)
            if dtype == 'float32':
                worst = 0.0
                for got, want in zip(metrics, ref['metrics']):
                    for key in want:
                        rtol = (TP_NORM_RTOL if key == 'grad_norm'
                                else TP_LOSS_RTOL)
                        err = abs(got[key] - want[key]) / abs(want[key])
                        assert err <= rtol, ('tp', key, got, want)
                        worst = max(worst, err)
                row['worst_loss_rel_err'] = worst
                for key, want in ref['losses'].items():
                    err = abs(losses[key] - want)
                    assert err <= TP_EVAL_TOL['atol'] + TP_EVAL_TOL['rtol'] \
                        * abs(want), ('tp eval', key, losses[key], want)
                row['worst_param_ratio'] = dp_ratio(params, ref['params'],
                                                    TP_PARAM_TOL)
                assert row['worst_param_ratio'] <= 1.0, row
                assert row['mel_mae'] <= MEL_MAE_BOUND, row
            else:
                f32 = one['float32']

                def bar(got, want, base, keys):
                    # the port's bf16 bar over the values of ``keys`` as
                    # one tensor: the largest error at most twice the
                    # largest of one process's bf16 distances from its
                    # f32, plus 1e-6
                    err = max(abs(got[key] - want[key]) for key in keys)
                    most = BF16_FACTOR * max(abs(want[key] - base[key])
                                             for key in keys) + BF16_ATOL
                    assert err <= most, ('tp bf16', keys, got, want, base)
                losses_of = list(ref['losses'])
                for got, want, base in zip(metrics, ref['metrics'],
                                           f32['metrics']):
                    bar(got, want, base, losses_of)
                    bar(got, want, base, ['grad_norm'])
                bar(losses, ref['losses'], f32['losses'], losses_of)
                params_err = max((params[k] - v).abs().max().item()
                                 for k, v in ref['params'].items())
                params_bar = BF16_FACTOR * max(
                    (v - f32['params'][k]).abs().max().item()
                    for k, v in ref['params'].items()) + BF16_ATOL
                row['params_bar_share'] = params_err / params_bar
                assert params_err <= params_bar, row
                mels_bar = BF16_FACTOR * ((ref['mels'] - f32['mels']).abs()
                                          * valid).max().item() + BF16_ATOL
                row['mels_bar_share'] = row['mel_max_abs'] / mels_bar
                assert row['mel_max_abs'] <= mels_bar, row
                # the gradients leaf by leaf: no further from one
                # process's bf16 than twice its bf16 distance from f32, plus
                # 1e-4; and within 3e-2 norm-relative of its f32 wherever
                # one process's bf16 is (the leaves where bf16 itself
                # misses 3e-2 are counted, held by the first bar alone)
                f32_grads = tp.shard_state_dict(f32['grads'], world, specs)
                worst, worst_f32, missed = (0.0, ''), (0.0, ''), []
                for name, want in mine.items():
                    own = norm_rel(want, f32_grads[name])
                    err = norm_rel(grads[name], want)
                    most = BF16_GRAD_FACTOR * own + BF16_GRAD_ATOL
                    assert err <= most, ('tp bf16 gradients', name, err,
                                         most)
                    worst = max(worst, (err / most, name))
                    if own >= BF16_GRAD_F32_BAR:
                        missed.append(name)
                        continue
                    worst_f32 = max(worst_f32, (norm_rel(
                        grads[name], f32_grads[name]), name))
                assert worst_f32[0] < BF16_GRAD_F32_BAR, worst_f32
                row['worst_grad_bar_share'], row['worst_grad'] = worst
                row['worst_grad_vs_f32'], row['worst_grad_f32'] = worst_f32
                row['bf16_itself_past_f32_bar'] = len(missed)
                row['bf16_leaves'] = len(mine)
        # each rank's step, then one process's alone
        row['step_ms'] = cuda_ms(lambda: step(batch), TP_TIMED, warmup=1)
        if world.is_main:
            row['single_process_step_ms'] = cuda_ms(
                lambda: one[dtype]['step'](batch), TP_TIMED, warmup=1)
        out[dtype] = row
    return out


def run_tensor_parallel_phase(card):
    """The shipped YAML's widths, Vanilla, at f32 and at bf16: two ranks on
    card 0 over gloo as one model group (NCCL refuses two ranks on one
    card), against one process on the same card (module of the ranks:
    :func:`tp_gloo_rank`).  Prints the bars held, each rank's launches
    (MAS alone: under tensor parallelism no flow kernel runs), the
    collectives of a step and the step times; returns the launches by
    path."""
    import tempfile
    root = tempfile.mkdtemp(prefix='chip_smoke_tp_')
    torch.cuda.empty_cache()       # this process's cache, for the ranks
    ranks, seconds = launch_ranks('tp', TP_RANKS, [0] * TP_RANKS, root)
    by_path = {}
    main = ranks[0]
    for dtype in ('float32', 'bfloat16'):
        for result in ranks:
            launches = result[dtype]['launches']
            by_path[f'tensor parallel {dtype} rank {result["rank"]}'] = \
                launches
            print(f'tensor parallel {dtype}: rank {result["rank"]} of '
                  f'{result["world_size"]} on {result["device"]} '
                  f'({result["backend"]}): launches ' + ', '.join(
                      f'{k} {v}' for k, v in launches.items() if v))
        row = main[dtype]
        coll = row['collectives']
        held = (f'losses within {row["worst_loss_rel_err"]:.2e} (bar '
                f'{TP_LOSS_RTOL}, grad_norm {TP_NORM_RTOL}), eval losses '
                f'(rtol {TP_EVAL_TOL["rtol"]}, atol {TP_EVAL_TOL["atol"]}), '
                f'weights after at {row["worst_param_ratio"]:.3f} of their '
                f'bar (rtol {TP_PARAM_TOL["rtol"]}, atol '
                f'{TP_PARAM_TOL["atol"]}), decode mel MAE '
                f'{row["mel_mae"]:.3e} (bar {MEL_MAE_BOUND})'
                if dtype == 'float32' else
                f'losses, eval losses and weights after within the bf16 '
                f'bar (weights at {row["params_bar_share"]:.3f} of it), '
                f'gradients at {row["worst_grad_bar_share"]:.3f} of theirs '
                f'({row["worst_grad"]}) and at most '
                f'{row["worst_grad_vs_f32"]:.2e} norm-relative from one '
                f'process\'s f32 (bar {BF16_GRAD_F32_BAR}; '
                f'{row["worst_grad_f32"]}; one process at bf16 itself past '
                f'that bar on {row["bf16_itself_past_f32_bar"]} of this '
                f'rank\'s {row["bf16_leaves"]} leaves), decode mels at '
                f'{row["mels_bar_share"]:.3f} of theirs (MAE '
                f'{row["mel_mae"]:.3e})')
        print(f'tensor parallel {dtype}: {TP_RANKS} ranks on card 0, '
              f'batch {row["shape"]} (tokens {row["tokens"]}), '
              f'{row["sharded_share"] * 100:.1f} % of the parameters '
              f'sharded, against one process on the same card: {held}; '
              f'log-durations within {row["log_duration_max_abs"]:.2e} '
              f'(held), {row["durations_flipped"]} of the '
              f'{row["durations_valid"]} ceiled durations flipped by one '
              f'(both decoded from one process\'s durations); replicated '
              f'gradients and MAS paths bit-equal across the ranks')
        print(f'tensor parallel {dtype}: a step\'s model-group collectives '
              f'{coll["all_reduce"]} all-reduces of '
              f'{coll["all_reduce_bytes"] / 1e6:.1f} MB and '
              f'{coll["all_gather"]} all-gathers of '
              f'{coll["all_gather_bytes"] / 1e6:.1f} MB; step '
              + ', '.join(f'{r[dtype]["step_ms"]:.1f}' for r in ranks)
              + f' ms by rank against one process\'s '
              f'{row["single_process_step_ms"]:.1f} ms by CUDA events '
              f'({card}); gloo through the host, two ranks on one card: '
              f'not a speed of tensor parallelism')
    print(f'tensor parallel phase: {seconds:.1f} s')
    print('tensor parallel: ' + json.dumps({
        dtype: {'step_ms': [r[dtype]['step_ms'] for r in ranks],
                'single_process_step_ms': main[dtype][
                    'single_process_step_ms'],
                'collectives': main[dtype]['collectives']}
        for dtype in ('float32', 'bfloat16')} | {'card': card}))
    return by_path


# ---------------------------------------------------------------------------
# data-parallel serving: two gloo ranks on one card against one process
# ---------------------------------------------------------------------------

SERVE_RANKS = 2                # data 2 × model 1, both ranks on card 0
SERVE_ITEMS = 32               # one global batch, in the 1024-frame bucket
SERVE_NOISE = 0.667
SERVE_TIMED = 2                # calls a timing takes, after one warm-up
SERVE_LD_TOL = TP_EVAL_TOL     # f32 log-durations against one process
SERVE_AUDIO_BOUND = 1e-3       # Griffin-Lim's waveform from those mels, max
                               # err over max-abs


def serve_items():
    """``SERVE_ITEMS`` requests: the serving texts cycled at length scales
    1 … 4, and last the longest at ``bench.py``'s length scale 8, which
    takes the 1024-frame bucket."""
    from glow_tts_tpu_torch.text import text_filtering
    texts = INFERENCE_TEXTS + [
        'It was a bright cold day in April, and the clocks were striking '
        'thirteen.']
    longest = ('It is easy to tell the depth of a well, and four hours of '
               'steady work faced us on that hot and dusty day.')
    return [{'label': f'serve_{i:02d}',
             'text': text_filtering(longest if i == SERVE_ITEMS - 1
                                    else texts[i % len(texts)]),
             'length_scale': 8.0 if i == SERVE_ITEMS - 1 else 1.0 + i % 4}
            for i in range(SERVE_ITEMS)]


def serve_log_durations(inferencer, items):
    """This rank's rows of the items' log-durations ``[rows, T_tok]``, as
    the ``Inferencer`` splits them."""
    world = inferencer.world
    n = len(items)
    share = -(-n // world.data_size)
    rows = [min(j, n - 1) for j in range(world.data_index * share,
                                         (world.data_index + 1) * share)]
    batch = inferencer.rows_of(inferencer.batch(items), n, rows)
    prior = inferencer.model.inference_prior(
        batch['tokens'], batch['token_lengths'], batch['length_scales'])
    return prior['log_durations'][..., 0].float().cpu()


def dp_serve_rank(config16):
    """Two ranks on card 0 over gloo as two data groups (data 2 × model
    1) at the shipped YAML's widths: ``SERVE_ITEMS`` items in one global
    batch under 'fused', at f32 (with the Griffin-Lim export) and at bf16
    (``inference_dtype`` too); rank 0 serves the same items as one
    process on the same card and holds the gathered results against it.
    Each rank's launches, log-durations, decode and Griffin-Lim times."""
    import tempfile

    from glow_tts_tpu_torch import Inferencer, random_state_dict
    from glow_tts_tpu_torch.ops import vocoder
    from glow_tts_tpu_torch.parallel import data as pdata
    shipped = dataclasses.replace(config16, data_parallel=SERVE_RANKS,
                                  model_parallel=1, coupling_backend='fused')
    world = pdata.initialize(shipped, 'cuda', backend='gloo')
    assert (world.backend, world.device, world.data_size) == (
        'gloo', torch.device('cuda', 0), SERVE_RANKS), world
    device = world.device
    single = dataclasses.replace(pdata.SINGLE, device=device)
    items = serve_items()
    out = {'rank': world.rank, 'world_size': world.size,
           'device': str(device), 'backend': world.backend}
    one = {}
    for dtype in ('float32', 'bfloat16'):
        config = dataclasses.replace(shipped, compute_dtype=dtype,
                                     inference_dtype=dtype)
        state = random_state_dict(config, SEED)
        inferencer = Inferencer(state, config, device,
                                batch_size=SERVE_ITEMS, world=world)
        wav = dtype == 'float32'
        # the files (rank 0's) under a directory of the rank's own
        out_dir = tempfile.mkdtemp(prefix='chip_smoke_serve_')
        zero_counts()
        results = inferencer.synthesize_items(
            items, noise_scale=SERVE_NOISE, seed=SEED, out_dir=out_dir,
            export_wav=wav)
        row = {'launches': read_counts()}
        assert row['launches'] == route_launches('fused', config, 1), row
        share = SERVE_ITEMS // SERVE_RANKS
        mine = range(world.data_index * share,
                     (world.data_index + 1) * share)
        row['bytes_gathered'] = sum(
            r['mel'].nbytes + r['attention'].nbytes
            + (r['audio'].nbytes if wav else 0)
            for i, r in enumerate(results) if i not in mine)
        row['bucket'] = results[0]['bucket']
        assert {r['bucket'] for r in results} == {1024}, row
        log_d = torch.cat(world.gather_data(
            serve_log_durations(inferencer, items)))

        def serving(model_inferencer):
            return lambda: model_inferencer.synthesize_items(
                items, noise_scale=SERVE_NOISE, seed=SEED)

        def griffin(mels):
            return lambda: [vocoder.mel_to_audio(mel, config.sound,
                                                 device=device)
                            for mel in mels]
        row['decode_ms'] = cuda_ms(serving(inferencer), SERVE_TIMED,
                                   warmup=0)
        if wav:
            row['griffin_lim_ms'] = cuda_ms(
                griffin([results[i]['mel'] for i in mine]), 1, warmup=0)
        if world.is_main:
            alone = Inferencer(state, config, device,
                               batch_size=SERVE_ITEMS, world=single)
            ref = alone.synthesize_items(
                items, noise_scale=SERVE_NOISE, seed=SEED,
                out_dir=tempfile.mkdtemp(prefix='chip_smoke_serve_one_'),
                export_wav=wav)
            ref_log_d = serve_log_durations(alone, items)
            one[dtype] = {'results': ref, 'log_d': ref_log_d}
            row['single_process_decode_ms'] = cuda_ms(serving(alone),
                                                      SERVE_TIMED, warmup=0)
            if wav:
                row['single_process_griffin_lim_ms'] = cuda_ms(
                    griffin([r['mel'] for r in ref]), 1, warmup=0)
            scales = torch.tensor([item['length_scale'] for item in items])
            lengths = alone.batch(items)['token_lengths'].cpu()
            mask = (torch.arange(ref_log_d.shape[1])[None, :]
                    < lengths[:, None]).float()
            row.update(compare_dp_served(results, ref, log_d, ref_log_d,
                                         dtype, one, mask, scales))
        out[dtype] = row
    return out


def serve_durations(log_d, mask, scales):
    """The ceiled durations ``[B, T_tok]`` of log-durations at the items'
    token ``mask`` and length scales, as ``inference_prior`` makes
    them."""
    return torch.ceil(torch.exp(log_d) * mask * scales[:, None])


def compare_dp_served(results, ref, log_d, ref_log_d, dtype, one, mask,
                      scales):
    """The gathered results against one process's: labels in order; the
    log-durations within their bar (f32: ``SERVE_LD_TOL``; bf16: twice one
    process's bf16 distance from its f32, plus 1e-6); the ceiled durations
    equal but where a ceil flips by one within that bar, at most one at
    f32 (at bf16 the encoder's products on 16 rows and on 32 round apart
    by an ulp, and the flips are counted); on every item whose durations
    agree, the mels (f32: MAE within ``MEL_MAE_BOUND``; bf16: MAE within
    twice one process's bf16 MAE from its f32, plus 1e-6, on the items
    whose durations agree there, or on every item over the frames both
    decoded where none does) and the audio (f32, within
    ``SERVE_AUDIO_BOUND`` of max-abs)."""
    assert [r['label'] for r in results] == [r['label'] for r in ref]
    row = {'log_duration_max_abs': (log_d - ref_log_d).abs().max().item()}
    if dtype == 'float32':
        assert torch.allclose(log_d, ref_log_d, **SERVE_LD_TOL), row
        bar = SERVE_LD_TOL['atol'] + SERVE_LD_TOL['rtol'] * ref_log_d.abs()
    else:
        bar = BF16_FACTOR * (ref_log_d - one['float32']['log_d']).abs(
            ).max().item() + BF16_ATOL
        row['log_duration_bar'] = bar
        assert row['log_duration_max_abs'] <= bar, row
    got_d, want_d = (serve_durations(d, mask, scales)
                     for d in (log_d, ref_log_d))
    # a flip must straddle an integer that the bar around one process's
    # log-duration reaches
    lo, hi = (serve_durations(ref_log_d + sign * bar, mask, scales)
              for sign in (-1, 1))
    flips = got_d != want_d
    row['durations_flipped'] = int(flips.sum())
    row['durations_valid'] = int(mask.sum())
    assert ((got_d - want_d).abs() <= 1).all(), row
    assert (lo[flips] != hi[flips]).all(), row
    if dtype == 'float32':
        assert row['durations_flipped'] <= 1, row

    def mel_errors(a_results, b_results, same):
        # over the items of ``same``, each over the frames both decoded
        err_sum, count, worst, audio, items = 0.0, 0, 0.0, 0.0, 0
        for a, b, keep in zip(a_results, b_results, same):
            if not keep:
                continue
            n = min(a['mel'].shape[0], b['mel'].shape[0])
            diff = np.abs(a['mel'][:n] - b['mel'][:n])
            err_sum, count = err_sum + diff.sum(), count + diff.size
            worst, items = max(worst, float(diff.max())), items + 1
            if 'audio' in a and 'audio' in b:
                audio = max(audio, float(np.abs(a['audio'] - b['audio']).max()
                                         / np.abs(b['audio']).max()))
        return float(err_sum / max(count, 1)), worst, audio, items

    same = (~flips).all(dim=1).tolist()
    row['mel_mae'], row['mel_max_abs'], audio, row['items_compared'] = \
        mel_errors(results, ref, same)
    if dtype == 'float32':
        assert row['mel_mae'] <= MEL_MAE_BOUND, row
        row['audio_max_rel_err'] = audio
        assert audio <= SERVE_AUDIO_BOUND, row
    else:
        f32 = one['float32']
        same_f32 = (serve_durations(f32['log_d'], mask, scales)
                    == want_d).all(dim=1).tolist()
        if not any(same_f32):
            # every item's bf16 durations differ somewhere from its f32:
            # every item, over the frames both decoded
            same_f32 = [True] * len(ref)
        base, _, _, row['items_bf16_as_f32'] = mel_errors(
            ref, f32['results'], same_f32)
        row['mel_mae_bar'] = BF16_FACTOR * base + BF16_ATOL
        assert row['mel_mae'] <= row['mel_mae_bar'], row
    return row


def run_data_parallel_serving_phase(card):
    """The shipped YAML's widths, Vanilla, at f32 and at bf16: two ranks
    on card 0 over gloo as two data groups (NCCL refuses two ranks on one
    card; module of the ranks: :func:`dp_serve_rank`) serve one global
    batch of ``SERVE_ITEMS`` items, each rank 16 of them through 12
    ``flow_step`` launches, against one process on the same card.  Prints
    the bars held, each rank's launches, the bytes gathered and the decode
    and Griffin-Lim times; returns the launches by path."""
    import tempfile
    root = tempfile.mkdtemp(prefix='chip_smoke_serve_')
    torch.cuda.empty_cache()       # this process's cache, for the ranks
    ranks, seconds = launch_ranks('serve', SERVE_RANKS, [0] * SERVE_RANKS,
                                  root)
    by_path = {}
    main = ranks[0]
    for dtype in ('float32', 'bfloat16'):
        for result in ranks:
            row = result[dtype]
            by_path[f'data-parallel serving {dtype} rank '
                    f'{result["rank"]}'] = row['launches']
            print(f'data-parallel serving {dtype}: rank {result["rank"]} of '
                  f'{result["world_size"]} on {result["device"]} '
                  f'({result["backend"]}): launches ' + ', '.join(
                      f'{k} {v}' for k, v in row['launches'].items() if v)
                  + f'; {row["bytes_gathered"] / 1e6:.2f} MB gathered from '
                  f'the other rank; bucket {row["bucket"]}')
        row = main[dtype]
        held = (f'mel MAE {row["mel_mae"]:.3e} (bar {MEL_MAE_BOUND}), '
                f'audio max err {row["audio_max_rel_err"]:.2e} of max-abs '
                f'(bar {SERVE_AUDIO_BOUND})' if dtype == 'float32' else
                f'mel MAE {row["mel_mae"]:.3e} (bf16 bar '
                f'{row["mel_mae_bar"]:.3e}, from one process\'s bf16 '
                f'against its f32 over {row["items_bf16_as_f32"]} '
                f'items), max-abs {row["mel_max_abs"]:.3e}; '
                f'log-durations bar {row["log_duration_bar"]:.3e}')
        print(f'data-parallel serving {dtype}: {SERVE_RANKS} ranks on card '
              f'0, {SERVE_ITEMS} items in one global batch, gathered on rank '
              f'0 against one process on the same card: {held}; '
              f'log-durations within {row["log_duration_max_abs"]:.2e}, '
              f'{row["durations_flipped"]} of {row["durations_valid"]} '
              f'ceiled durations flipped by one within that bar, '
              f'{row["items_compared"]} items of equal durations compared')
        times = ', '.join(f'{r[dtype]["decode_ms"]:.1f}' for r in ranks)
        line = (f'data-parallel serving {dtype}: serving call (prior, '
                f'decode, gather) {times} ms by rank against one process\'s '
                f'{row["single_process_decode_ms"]:.1f} ms')
        if dtype == 'float32':
            line += (', Griffin-Lim of its own items ' + ', '.join(
                f'{r[dtype]["griffin_lim_ms"]:.1f}' for r in ranks)
                + f' ms by rank against one process\'s '
                f'{row["single_process_griffin_lim_ms"]:.1f} ms for all '
                f'{SERVE_ITEMS}')
        print(line + f', by CUDA events ({card}); gloo ranks sharing one '
              f'card: not a speed')
    print(f'data-parallel serving phase: {seconds:.1f} s')
    print('data-parallel serving: ' + json.dumps({
        dtype: {key: [r[dtype].get(key) for r in ranks]
                for key in ('decode_ms', 'griffin_lim_ms',
                            'bytes_gathered')}
        | {key: main[dtype].get(key) for key in (
            'single_process_decode_ms', 'single_process_griffin_lim_ms',
            'mel_mae', 'mel_max_abs', 'log_duration_max_abs',
            'durations_flipped')}
        for dtype in ('float32', 'bfloat16')} | {'card': card}))
    return by_path


# ---------------------------------------------------------------------------
# observability: the writers, the PNGs, the profiler window, the prosody check
# ---------------------------------------------------------------------------

OBS_STEPS = 4                  # the Vanilla trainer's steps
OBS_EVAL_EVERY = 2             # its evaluations: steps 0, 2 and 4
OBS_PROFILE = (1, 3)           # its profiler window: steps 1 and 2 (0-based)
OBS_IMAGES = ('Attention/From_Inference', 'Attention/From_Train',
              'Mel/Target')
OBS_SPEAKERS, OBS_PER_SPEAKER = 6, 8     # the prosody check's archive
OBS_FRAMES = (200, 800)        # its utterances' mel frames
OBS_PE_STEPS = 2               # the PE trainer's steps; its check at the last
GST_F32_REL_BOUND = 1e-4       # GST vectors card vs CPU at f32, of max-abs
OBS_TIMED = 2                  # evaluations timed each way, alternating
# the kernels of each source by their function names, as the trace names
# them (demangled, in the sources' anonymous namespace)
TRACE_KERNELS = {
    'mas': ('mas_recurrence', 'mas_expand'),
    'train_fwd': ('flow_train_fwd_kernel',),
    'train_bwd': ('gemm_nt', 'gemm_nt_tail', 'gemm_tn', 'gemm_pair',
                  'gemm_pair_tail', 'column_sums', 'pitch_backward',
                  'reduce_partials', 'affine_backward')}


def importable(name):
    import importlib
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


class TeeWriter:
    """Hands each call to every one of ``writers``."""

    def __init__(self, *writers):
        self.writers = writers

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for writer in self.writers:
                getattr(writer, name)(*args, **kwargs)
        return call


class ScalarsOnly:
    """``writer``'s scalars, and no images, histograms or embeddings."""

    def __init__(self, writer):
        self.writer = writer

    def add_scalars(self, scalars, step):
        self.writer.add_scalars(scalars, step)

    def add_images(self, *args, **kwargs):
        pass

    add_histograms = add_embedding = add_images


class WarningRecords(logging.Handler):
    """The warnings the port's logger gives inside a ``with`` block."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger('glow_tts_tpu_torch').addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger('glow_tts_tpu_torch').removeHandler(self)


def read_event_files(log_dir):
    """Every ``Event`` of the TensorBoard event files under ``log_dir``
    (TFRecord framing: a length, its CRC, the record, its CRC)."""
    import glob
    import struct
    from tensorboardX.proto import event_pb2
    events = []
    for path in sorted(glob.glob(os.path.join(log_dir, 'events.*'))):
        with open(path, 'rb') as f:
            while True:
                header = f.read(12)
                if len(header) < 12:
                    break
                length, = struct.unpack('<Q', header[:8])
                event = event_pb2.Event()
                event.ParseFromString(f.read(length))
                f.read(4)
                events.append(event)
    return events


def summaries(log_dir, kind):
    """``tag → [(step, value)]`` of the summaries of ``kind``
    (``'simple_value'``, ``'image'``, ``'histo'``) under ``log_dir``."""
    out = {}
    for event in read_event_files(log_dir):
        for value in event.summary.value:
            if value.WhichOneof('value') == kind:
                out.setdefault(value.tag, []).append(
                    (event.step, getattr(value, kind)))
    return out


def trace_kernels(path):
    """(kernel events of the Chrome trace at ``path`` by source of
    ``TRACE_KERNELS`` and by function name, every kernel event's name with
    its count)."""
    import re
    from collections import Counter
    with open(path) as f:
        events = json.load(f)['traceEvents']
    names = Counter(event['name'] for event in events
                    if event.get('cat') == 'kernel')
    by_fn = {}
    for fns in TRACE_KERNELS.values():
        for fn in fns:
            pattern = re.compile(rf'(?:^|[\s:]){fn}(?:[(<]|$)')
            by_fn[fn] = sum(count for name, count in names.items()
                            if pattern.search(name))
    by_source = {source: sum(by_fn[fn] for fn in fns)
                 for source, fns in TRACE_KERNELS.items()}
    return by_source, by_fn, names


def write_speaker_archive(path, config, seed):
    """``OBS_SPEAKERS`` × ``OBS_PER_SPEAKER`` patterns of ``OBS_FRAMES``
    mel frames (a folder per speaker) with the port's pattern IO, texts of
    10 … 200 characters."""
    from glow_tts_tpu_torch.data.patterns import (build_metadata,
                                                  save_metadata, save_pattern)
    rng = np.random.default_rng(seed)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    a = config.sound.max_abs_mel
    for s in range(OBS_SPEAKERS):
        for i in range(OBS_PER_SPEAKER):
            n_mel = int(rng.integers(OBS_FRAMES[0], OBS_FRAMES[1] + 1))
            chars = rng.choice(letters, int(rng.integers(10, 201)))
            chars[5::6] = ' '
            save_pattern(os.path.join(path, f'Speaker{s}', f'P{i:02d}.PICKLE'),
                         {'Audio': np.zeros(n_mel, np.float32),
                          'Mel': rng.uniform(-a, a, (n_mel, config.sound.mel_dim)
                                             ).astype(np.float32),
                          'Pitch': np.zeros(n_mel, np.float32),
                          'Speaker_ID': s, 'Speaker': f'Speaker{s}',
                          'Dataset': 'Synthetic', 'Text': ''.join(chars)})
    save_metadata(path, build_metadata(path, config.sound))


def observe_trainer(shipped, root, device, card, packages):
    """The shipped YAML as shipped (bf16, Vanilla) through ``Trainer`` at
    B = 32: ``OBS_STEPS`` steps, evaluations at 0, 2 and 4, the inference
    TSV at 4, ``train(profile_steps=OBS_PROFILE)``, its default writers
    (``SummaryLogger``s) where tensorboardX imports, each teed into a
    ``MemoryWriter``.  Checks the writers, the trace against the launch
    counters and the PNGs; times an evaluation with and without its
    images and histograms, and the steps inside and outside the window.
    Returns the launches and the numbers."""
    import glob

    from glow_tts_tpu_torch import Trainer
    from glow_tts_tpu_torch.utils import plotting
    from glow_tts_tpu_torch.utils.logging import MemoryWriter, histogram_tag
    config = trainer_config(shipped, root, 'observed', OBS_STEPS)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, evaluation_interval=OBS_EVAL_EVERY,
        inference_interval=OBS_STEPS))
    assert config.compute_dtype == 'bfloat16'
    memory = {'train': MemoryWriter(), 'eval': MemoryWriter()}
    # the one warning of a machine without matplotlib, in this run
    plotting._MISSING.clear()
    zero_counts()
    with WarningRecords() as warned:
        if packages['tensorboardX']:
            trainer = Trainer(config, device=device)
            default = trainer.writers
            assert {type(w).__name__ for w in default.values()} == {
                'SummaryLogger'}, default
            trainer.writers = {kind: TeeWriter(writer, memory[kind])
                               for kind, writer in default.items()}
        else:
            try:
                Trainer(config, device=device)
            except ImportError as error:
                assert 'tensorboardX' in str(error), error
            else:
                raise AssertionError('SummaryLogger built without '
                                     'tensorboardX')
            trainer = Trainer(config, device=device, writers=memory)
            default = memory
        edges, step_events, evals = {}, {}, {}
        step_function, after_step = trainer.step_function, \
            trainer._after_step
        eval_step = trainer.eval_step

        def timed_step_function(step):
            if step == OBS_PROFILE[0]:         # the window has just begun
                edges['start'] = read_counts()
            fn = step_function(step)

            def run(batch):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(batch)
                end.record()
                step_events[step] = (start, end)
                return out
            return run

        def counted_after_step(metrics, frames):
            if trainer.step == OBS_PROFILE[1]:     # the window has ended
                edges['stop'] = read_counts()
            return after_step(metrics, frames)

        def recorded_eval(batch):
            out = eval_step(batch)
            evals[trainer.step] = (batch, out[1])
            return out

        trainer.step_function = timed_step_function
        trainer._after_step = counted_after_step
        trainer.eval_step = recorded_eval
        trainer.train(profile_steps=OBS_PROFILE)
        launches = read_counts()
    step_ms = {step: start.elapsed_time(end)
               for step, (start, end) in sorted(step_events.items())}

    # the trace against the launch counters over the same window
    traces = glob.glob(os.path.join(config.log_path, 'profile',
                                    'rank0.*.pt.trace.json'))
    assert len(traces) == 1, traces
    by_source, by_fn, names = trace_kernels(traces[0])
    grew = {key: edges['stop'][key] - edges['start'][key]
            for key in edges['stop']}
    counted = {'mas': 2 * grew['mas'],
               'train_fwd': sum(v for k, v in grew.items()
                                if k.startswith(('train_fwd',
                                                 'train_recompute'))),
               'train_bwd': sum(v for k, v in grew.items()
                                if k.startswith('train_bwd'))}
    window = OBS_PROFILE[1] - OBS_PROFILE[0]
    eval_batches = -(-EVAL_PATTERNS // config.train.batch_size)
    steps = config.decoder.stack
    print(f'observability, profiler window of steps {OBS_PROFILE[0]}–'
          f'{OBS_PROFILE[1] - 1} ({window} train steps and the evaluation '
          f'at step {OBS_EVAL_EVERY}): {sum(names.values())} kernel events '
          f'in {os.path.basename(traces[0])} '
          f'({os.path.getsize(traces[0]) / 1e6:.1f} MB); by source, trace '
          f'{by_source} against the launch counters\' increase {counted} '
          f'(#1 two kernels a launch; by function {by_fn})')
    for name, count in names.most_common(12):
        print(f'  {count:6d} x  {name[:100]}')
    assert by_source == counted, (by_source, counted)
    assert by_fn['mas_recurrence'] == by_fn['mas_expand'] == grew['mas']
    assert grew['train_fwd_bf16'] == window * steps, grew
    assert grew['train_bwd_bf16'] == (window * steps
                                      * BWD_KERNELS_PER_FLOW_STEP), grew
    assert grew['mas'] == window + eval_batches, grew

    # what the writers hold: the images' arrays are the eval step's and
    # the decode's slices, the histograms the parameters on the card
    eval_steps = list(range(0, OBS_STEPS + 1, OBS_EVAL_EVERY))
    images = memory['eval'].images
    assert sorted(images) == list(OBS_IMAGES), sorted(images)
    for tag, entries in images.items():
        assert [step for step, _ in entries] == eval_steps, (tag, entries)
    for i, step in enumerate(eval_steps):
        batch, outputs = evals[step]
        t_tok = int(batch['token_lengths'][0])
        t_mel = int(batch['mel_lengths'][0])
        assert np.array_equal(
            images['Attention/From_Train'][i][1],
            outputs['attentions'][0, :t_tok, :t_mel].float().cpu().numpy())
        assert np.array_equal(images['Mel/Target'][i][1],
                              batch['mels'][0, :t_mel].float().cpu()
                              .numpy().T)
    assert np.array_equal(
        images['Attention/From_Inference'][-1][1],
        trainer.free_running['attentions'][0, :t_tok].float().cpu().numpy())
    params = dict(trainer.model.named_parameters())
    histograms = memory['eval'].histograms
    assert set(histograms) == {histogram_tag(n) for n in params}
    for name, value in params.items():
        entries = histograms[histogram_tag(name)]
        assert [step for step, _ in entries] == eval_steps, name
        assert np.array_equal(entries[-1][1], value.detach().cpu().numpy()), \
            name
    events = {}
    if packages['tensorboardX']:
        for writer in default.values():     # the writers' queued events
            writer.writer.flush()
        log = {kind: os.path.join(config.log_path, sub)
               for kind, sub in (('train', 'Train'), ('eval', 'Evaluation'))}
        for kind in ('train', 'eval'):
            scalars = summaries(log[kind], 'simple_value')
            want = memory[kind].scalars
            assert set(scalars) == set(want), (kind, set(scalars))
            for tag, values in want.items():
                assert [(s, np.float32(v)) for s, v in values] == [
                    (s, np.float32(v)) for s, v in scalars[tag]], (kind, tag)
        pictures = summaries(log['eval'], 'image')
        histos = summaries(log['eval'], 'histo')
        assert sorted(pictures) == (list(OBS_IMAGES) if packages['matplotlib']
                                    else []), sorted(pictures)
        for tag, entries in pictures.items():
            assert [s for s, _ in entries] == eval_steps, tag
            assert all(image.height > 100 and image.width > 100
                       for _, image in entries), tag
        assert set(histos) == {histogram_tag(n) for n in params}
        for name, value in params.items():
            entries = histos[histogram_tag(name)]
            assert [s for s, _ in entries] == eval_steps, name
            histo = entries[-1][1]
            host = value.detach().cpu()
            assert (histo.num, histo.min, histo.max) == (
                host.numel(), float(host.min()), float(host.max())), name
        events = {'eval_images': sum(map(len, pictures.values())),
                  'eval_histograms': sum(map(len, histos.values())),
                  'scalar_tags': sum(len(summaries(log[k], 'simple_value'))
                                     for k in log)}
        print(f'observability, event files read back: {events}; '
              f'{len(params)} parameters')

    # the PNGs of the inference at the last step
    png_dir = os.path.join(config.inference_path, f'Step-{OBS_STEPS}', 'PNG')
    matplotlib_warnings = [m for m in warned.messages if 'matplotlib' in m]
    if packages['matplotlib']:
        from matplotlib.image import imread
        files = sorted(os.listdir(png_dir))
        assert files == [f'T{i}.png' for i in range(len(INFERENCE_TEXTS))], \
            files
        shapes = [imread(os.path.join(png_dir, f)).shape for f in files]
        assert all(len(s) == 3 and s[0] > 100 for s in shapes), shapes
        assert not matplotlib_warnings, matplotlib_warnings
        print(f'observability, inference at step {OBS_STEPS}: {len(files)} '
              f'PNGs read back, {shapes[0]}')
    else:
        assert not os.path.exists(png_dir), png_dir
        assert len(matplotlib_warnings) == 1, warned.messages
        print(f'observability: matplotlib does not import; the PNGs and '
              f'image summaries skipped with one warning: '
              f'{matplotlib_warnings[0]}')

    # an evaluation with its images and histograms against one without
    eval_writer = default['eval']
    with_ms, without_ms = [], []
    for _ in range(OBS_TIMED):
        trainer.writers = dict(default)
        with_ms.append(cuda_ms(trainer.evaluate, 1, warmup=0))
        trainer.writers = {**default, 'eval': ScalarsOnly(eval_writer)}
        without_ms.append(cuda_ms(trainer.evaluate, 1, warmup=0))
    print(f'observability, evaluate() ({EVAL_PATTERNS} patterns, the '
          f'decode, by CUDA events) with its images and {len(params)} '
          f'histograms ({type(eval_writer).__name__}): '
          f'{", ".join(f"{ms:.1f}" for ms in with_ms)} ms; scalars only: '
          f'{", ".join(f"{ms:.1f}" for ms in without_ms)} ms; train steps '
          f'by CUDA events, outside / inside the profiler window: '
          + ', '.join(f'step {s} {ms:.2f}'
                      + (' (in)' if OBS_PROFILE[0] <= s < OBS_PROFILE[1]
                         else '') for s, ms in step_ms.items())
          + f' ms; {card}')
    return launches, {'evaluate_ms': with_ms, 'evaluate_scalars_only_ms':
                      without_ms, 'step_ms': step_ms, 'trace': by_source,
                      'events': events}


def observe_prosody_check(root, device, card, packages):
    """PE at the shipped width and dtype: a ``Trainer`` on an archive of
    ``OBS_SPEAKERS`` speakers (its eval set too) trains ``OBS_PE_STEPS``
    steps and runs its prosody check at the last; the GST vectors of the
    card held against the same weights on the CPU, at f32 and at bf16;
    the check timed.  Returns the launches and the numbers."""
    from glow_tts_tpu_torch import GlowTTS, Trainer
    from glow_tts_tpu_torch.data.collate import ProsodyCheckCollater
    from glow_tts_tpu_torch.data.patterns import ProsodyCheckDataset
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    from glow_tts_tpu_torch.weights import load_state_dict
    config = mode_config('PE', dtype='bfloat16')
    for part, seed in (('train', SEED + 40), ('eval', SEED + 41)):
        write_speaker_archive(os.path.join(root, part), config, seed)
    config = trainer_config(config, root, 'pe', OBS_PE_STEPS,
                            inference=False)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, prosody_check_interval=OBS_PE_STEPS,
        evaluation_interval=100))
    memory = {'train': MemoryWriter(), 'eval': MemoryWriter()}
    zero_counts()
    trainer = Trainer(config, device=device, writers=memory)
    trainer.train()
    launches = read_counts()
    (step, card16, labels), = memory['eval'].embeddings['GST']
    assert step == OBS_PE_STEPS
    n = len(labels)
    assert n >= OBS_SPEAKERS * OBS_PER_SPEAKER * 0.9, n
    check_ms = [cuda_ms(trainer.prosody_check, 1, warmup=0)
                for _ in range(2)]
    with trainer.model.computing_at('float32'):
        card32, labels32 = trainer.prosody_check()

    # the same weights and mels on the CPU
    cpu = load_state_dict(GlowTTS(config),
                          {k: v.detach().cpu() for k, v in
                           trainer.model.state_dict().items()}).eval()
    pattern = config.train.eval_pattern
    dataset = ProsodyCheckDataset(
        pattern.path, mel_length_min=pattern.mel_length_min,
        mel_length_max=pattern.mel_length_max)
    collate = ProsodyCheckCollater(config)
    size = config.train.batch_size
    batches = [collate([dataset[i] for i in range(s, min(s + size, n))])
               for s in range(0, len(dataset), size)]
    cpu_labels = [label for b in batches for label in b['labels']]
    assert labels == labels32 == cpu_labels
    assert len(set(labels)) == OBS_SPEAKERS, set(labels)
    plain = {}
    for dtype in ('float32', 'bfloat16'):
        with cpu.computing_at(dtype):
            plain[dtype] = torch.cat([cpu.encode_prosody(
                torch.from_numpy(b['mels']),
                torch.from_numpy(b['mel_lengths'])).float()
                for b in batches]).numpy()
    scale = np.abs(plain['float32']).max()
    err32 = np.abs(card32 - plain['float32']).max() / scale
    err16 = float(np.abs(card16 - plain['bfloat16']).max())
    bar16 = 2 * float(np.abs(plain['bfloat16'] - plain['float32']).max()) \
        + 1e-6
    frames = sum(int(b['mel_lengths'].sum()) for b in batches)
    print(f'observability, PE prosody check at step {step} ({n} mels of '
          f'{len(set(labels))} speakers, {frames} frames, batches of '
          f'{size}): card vs CPU on the same weights: f32 '
          f'{err32:.2e} of max-abs (bar {GST_F32_REL_BOUND}), bf16 '
          f'max-abs {err16:.3e} (bar {bar16:.3e}: 2 × the CPU\'s bf16 vs '
          f'f32 + 1e-6); labels equal; the check at bf16 '
          f'{", ".join(f"{ms:.1f}" for ms in check_ms)} ms by CUDA events '
          f'({min(check_ms) * 100 / n:.2f} ms per 100 mels); {card}')
    assert err32 <= GST_F32_REL_BOUND, err32
    assert err16 <= bar16, (err16, bar16)
    viz = None
    if packages['sklearn'] and packages['matplotlib']:
        from matplotlib.image import imread
        from glow_tts_tpu_torch.utils import prosody_viz
        out = os.path.join(root, 'prosody_tsne.png')
        embeddings, viz_labels = prosody_viz.embed_prosody_dataset(
            config.checkpoint_path, device=str(device))
        viz = float(np.abs(embeddings - card32).max() / scale)
        assert viz_labels == labels and viz <= GST_F32_REL_BOUND, viz
        prosody_viz.plot_embeddings(embeddings, viz_labels, out)
        print(f'observability, prosody_viz on the checkpoint (the served '
              f'model, f32): {viz:.2e} of max-abs from the check\'s; '
              f't-SNE PNG {imread(out).shape}')
    return launches, {'f32_rel_err': float(err32), 'bf16_err': err16,
                      'bf16_bar': bar16, 'check_ms': check_ms,
                      'ms_per_100_mels': min(check_ms) * 100 / n,
                      'mels': n, 'viz_rel_err': viz}


def run_observability_phase(card):
    """What a user reads of a run: which of tensorboardX, matplotlib and
    sklearn import here, the Vanilla trainer's writers, PNGs and profiler
    trace (:func:`observe_trainer`), and PE's prosody check
    (:func:`observe_prosody_check`).  Returns the launches by path."""
    import shutil
    import tempfile

    from glow_tts_tpu_torch import load_config
    packages = {name: importable(name)
                for name in ('tensorboardX', 'matplotlib', 'sklearn')}
    print('observability packages: ' + ', '.join(
        f'{name} {"imports" if ok else "does not import"}'
        for name, ok in packages.items()))
    device = torch.device('cuda', 0)
    # as main() sets them, also when the phase runs alone: the GST
    # vectors are held against the CPU at f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix='chip_smoke_observed_')
    try:
        shipped = load_config(CONFIG)
        write_archive(os.path.join(root, 'train'), TRAIN_PATTERNS, shipped,
                      SEED + 30)
        write_archive(os.path.join(root, 'eval'), EVAL_PATTERNS, shipped,
                      SEED + 31)
        with open(os.path.join(root, 'sentences.tsv'), 'w') as f:
            f.write('Label\tText\tScale\tSpeaker\tGE2E\tProsody\tPitch\n')
            for i, text in enumerate(INFERENCE_TEXTS):
                f.write(f'T{i}\t{text}\t1.0\t0\tNone\tNone\tNone\n')
        by_path = {}
        by_path['observability trainer'], trained = observe_trainer(
            shipped, root, device, card, packages)
        by_path['observability prosody check'], checked = \
            observe_prosody_check(os.path.join(root, 'pe'), device, card,
                                  packages)
        print('observability: ' + json.dumps({
            'packages': packages, **trained, 'prosody_check': checked,
            'card': card}))
        return by_path
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this script runs on a GPU only')
    from glow_tts_tpu_torch import (Inferencer, TrainCollater,
                                    batch_to_device, initial_state_dict,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.ops import coupling, coupling_grad, cuda_build, mas
    from glow_tts_tpu_torch.text import Tokenizer, text_filtering

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    begun = start = time.perf_counter()
    # (source, defines): every library the run loads, the MAS kernel's and
    # each flow source's eight builds: 160 and 80 channels, each with its
    # pitch instantiation (the pitch operand 2 and 1 wide), at float32 and
    # at bfloat16; one nvcc each, all started together before the first
    # phase
    flow_loaders = (('flow_step', 'flow_step.cu',
                     coupling.load_flow_step_library),
                    ('coupling', 'coupling.cu',
                     coupling.load_coupling_library),
                    ('flow_stack', 'flow_stack.cu',
                     coupling.load_flow_stack_library),
                    ('train_fwd', 'flow_train_fwd.cu',
                     coupling_grad.load_train_forward_library),
                    ('train_bwd', 'flow_train_bwd.cu',
                     coupling_grad.load_train_backward_library))
    b2_sources = {(source, coupling.build_defines(shape, ps, bf16)):
                  functools.partial(load, ps, shape, bf16)
                  for label, (shape, ps) in B2_SHAPES.items()
                  for name, source, load in flow_loaders
                  for bf16 in (at == 'bfloat16'
                               for at in b2_builds(label).get(name, ()))}
    sources = {('mas.cu', ()): mas.load_mas_library,
               **{(source, coupling.build_defines(channels, pitch, bf16)):
                  functools.partial(load, pitch, channels, bf16)
                  for bf16 in (False, True) for channels in (160, 80)
                  for pitch in (False, True)
                  for _, source, load in flow_loaders},
               # the flow sources at the B.2 shapes, each at the dtypes the
               # B.2 phase runs (b2_builds)
               **b2_sources}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each, together
        for build in [pool.submit(load) for load in sources.values()]:
            build.result()
    phases = {}

    def phase_done(name):
        # seconds each phase took, printed at the end
        nonlocal start
        torch.cuda.synchronize()
        now = time.perf_counter()
        phases[name] = round(now - start, 1)
        start = now

    print(f'kernel builds: {len(sources)} libraries built and loaded in '
          f'{time.perf_counter() - start:.1f} s ({len(b2_sources)} of '
          f'them the B.2 shapes\' builds)')
    for source, defines in sources:
        for line in cuda_build.ptxas_report(source, defines):
            print(f'  ptxas {line}')
    phase_done('build')

    shipped = load_config(CONFIG)
    assert shipped.compute_dtype == 'bfloat16'   # the YAML as shipped
    # every phase before the bfloat16 one pins float32, as PRs before the
    # bfloat16 builds ran them
    config = dataclasses.replace(shipped, compute_dtype='float32')
    assert config.flow_route == 'fused'          # the shipped 'auto'
    configs = {route: dataclasses.replace(config, coupling_backend=route)
               for route in ROUTES}
    state = random_state_dict(config, SEED)
    inferencers = {route: Inferencer(state, configs[route], device,
                                     batch_size=2) for route in ROUTES}
    inferencer = inferencers['fused']
    worst, step_one_pass = check_kernel(inferencer.model, device)
    coupling_err = check_coupling(inferencer.model, device)
    stack_err = check_flow_stack(inferencer.model, device)
    mas_err = check_mas(device)

    # serving, under each route: the same requests, seed and weights
    by_path, served = {}, {}
    for route in ROUTES:
        by_path[f'serve {route}'], served[route] = serve(
            inferencers[route], config, route)
        compare_decode(inferencers[route],
                       ['The birch canoe slid on the smooth planks.',
                        'Glue the sheet to the dark blue background.'], 256)
    compare_served(served)
    long_text = ('It is easy to tell the depth of a well, and four hours '
                 'of steady work faced us on that hot and dusty day.')
    tokens, lengths, _ = inferencer.collate(
        [{'text': text_filtering(long_text)}] * 32)
    prior_1024 = inferencer.model.inference_prior(tokens, lengths, 4.0)

    # the loss path: a from-scratch model, initialised on its first batch
    collater = TrainCollater(config, Tokenizer())
    batches = [batch_to_device(collater(synthetic_items(config, SEED + k)),
                               device) for k in (10, 11)]
    model = fresh_model(initial_state_dict(config, SEED), config, device)
    check_ddi(model, batches[0], config)
    by_path['eval fused'] = run_eval(model, batches, config)
    compare_eval('from scratch', model, batches[0], config)
    # and with live couplings (a nonzero end conv), which a from-scratch
    # model does not have yet, under each route from the same weights
    live = fresh_model(state, config, device)
    live.data_dependent_init(batches[0]['mels'], batches[0]['mel_lengths'])
    models = {route: live if route == 'fused' else
              fresh_model(live.state_dict(), configs[route], device)
              for route in ROUTES}
    route_losses = {}
    for route in ROUTES:
        if route != 'fused':
            by_path[f'eval {route}'] = run_eval(
                models[route], batches[1:], configs[route], route)
        route_losses[route] = compare_eval(
            f'live couplings under {route!r}', models[route], batches[1],
            configs[route])
    for route in ('modules', 'mega'):
        for key in ('mle', 'duration'):
            a, b = (route_losses[r][key].item() for r in (route, 'fused'))
            assert abs(a - b) <= LOSS_REL_BOUND * abs(b), (route, key, a, b)

    # the train path: kernels #5 and #6 against the plain version on the
    # operands of a train step, then the steps themselves
    trainee = train_model(state, config, device)
    trainee.data_dependent_init(batches[0]['mels'], batches[0]['mel_lengths'])
    x, mask, weights = stack_problem(trainee, batches[0], config)
    del trainee
    fwd_err, fwd_one_pass = check_train_forward(x, mask, weights)
    bwd_err = check_train_backward(x, mask, weights)
    by_path['train'] = run_training(config, batches[0], device)
    phase_done('kernels, serving, eval and train paths')

    flow_times, coupling_times, stack_times = time_flow_kernels(
        inferencer.model, device, mask)
    time_routes(inferencers, models, prior_1024, batches[0])
    mas_times, eval_step = time_eval(model, batches[0], config, device)
    fwd_times, bwd_times = time_training(config, batches[0], x, mask,
                                         weights, device)
    profile_window('eval steps', lambda: eval_step(batches[0]), 3)
    phase_done('timings')
    # ROADMAP C.5: the f32 encoder under PyTorch's default flags
    run_f32_default_flags_phase(state, config, batches, device, card)
    phase_done('f32 under default flags')
    # the conditioned modes: GR's pitch instantiations, serving, the forward
    pitch_rows, conditioned_paths = run_conditioned_phase(
        {route: inferencers[route].model for route in ROUTES}, batches[0],
        mask, device)
    by_path.update(conditioned_paths)
    phase_done('conditioned serving')
    # training the conditioned modes: #5's and #6's pitch builds, GR, SE, PE
    train_pitch_rows, conditioned_paths = run_conditioned_training(config,
                                                                  device)
    by_path.update(conditioned_paths)
    phase_done('conditioned training')
    # the shipped YAMLs as shipped: bfloat16, through the bf16 builds
    bf16_rows, bf16_paths = run_bf16_phase(inferencer.model, batches, device,
                                           card)
    by_path.update(bf16_paths)
    phase_done('bf16')
    # bf16 under 'modules' and 'mega': #2's and #4's bf16 builds
    routes_rows, routes_paths = run_bf16_routes_phase(batches, device, card)
    by_path.update(routes_paths)
    phase_done('bf16 routes')
    # GR at Num_Squeeze 1: the pitch operand 1 wide in every flow kernel
    squeeze1_rows, squeeze1_paths = run_gr_squeeze1_phase(
        pitch_rows, train_pitch_rows, device, card)
    by_path.update(squeeze1_paths)
    phase_done('GR squeeze 1')
    # ROADMAP B.2: every flow kernel at other decoder shapes (100-bin mels,
    # tiny_config's decoder, another WaveNet); serving, eval and training
    # at C = 200 held to the plain versions
    b2_rows, b2_paths = run_b2_shapes_phase(card, device)
    by_path.update(b2_paths)
    phase_done('B.2 shapes')
    # MiniSpeech, the converged recipe: the 80-channel builds, the
    # curriculum and its trainer
    minispeech_rows, minispeech_paths = run_minispeech_phase(device, card)
    by_path.update(minispeech_paths)
    phase_done('MiniSpeech')
    by_path.update(run_trainer_phase(config, device, card))
    phase_done('trainer')
    # from wavs to wavs: the ETL, the export and the reference-wav features
    by_path.update(run_wav_phase(device, card))
    phase_done('wavs')
    # data parallelism: the ranks as processes of this script, NCCL over
    # every card, then two ranks on one card over gloo
    by_path.update(run_data_parallel_phase(card))
    phase_done('data parallel')
    # tensor parallelism: two ranks of one model group on one card over
    # gloo, against one process
    by_path.update(run_tensor_parallel_phase(card))
    phase_done('tensor parallel')
    # data-parallel serving: two data groups on one card over gloo, against
    # one process
    by_path.update(run_data_parallel_serving_phase(card))
    phase_done('data-parallel serving')
    # what a user reads of a run: the writers, the PNGs, the profiler
    # window and the prosody check
    by_path.update(run_observability_phase(card))
    phase_done('observability')

    def launches(counter):
        paths = {path: counts[counter] for path, counts in by_path.items()}
        assert sum(paths.values()) > 0, f'{counter}: launched on no path'
        return {'launches': sum(paths.values()), 'launches_by_path': paths}

    csrc = 'glow_tts_tpu_torch/csrc/'
    # the body the bfloat16 builds of #3, #4 and #2 run
    ring = {'body': csrc + 'flow_ring.cuh (GLOW_BF16_RING)'}

    def ring_body(name, defines):
        return ring if (name in ('flow_step', 'flow_stack', 'coupling')
                        and 'GLOW_BF16' in defines) else {}
    print(json.dumps({'kernels': [
        {'name': 'flow_step', 'route': 'cuda', 'source': csrc + 'flow_step.cu',
         'replaces': 'glow_tts_tpu/ops/coupling.py:190',
         'entry': 'fused_flow_step', **launches('flow_step'),
         'max_abs_err': worst, 'one_pass_max_rel_err': step_one_pass,
         **flow_times, 'library_ms': None},
        {'name': 'coupling', 'route': 'cuda', 'source': csrc + 'coupling.cu',
         'replaces': 'glow_tts_tpu/ops/coupling.py:190',
         'entry': 'fused_coupling', **launches('coupling'),
         'max_abs_err': coupling_err, **coupling_times, 'library_ms': None},
        {'name': 'flow_stack', 'route': 'cuda',
         'source': csrc + 'flow_stack.cu',
         'replaces': 'glow_tts_tpu/ops/coupling.py:296',
         'entry': 'fused_flow_stack', **launches('flow_stack'),
         'max_abs_err': stack_err, **stack_times, 'library_ms': None},
        {'name': 'mas', 'route': 'cuda', 'source': csrc + 'mas.cu',
         'replaces': 'glow_tts_tpu/ops/mas.py:147',
         'entry': 'maximum_path_pallas', **launches('mas'),
         'max_abs_err': mas_err, **mas_times, 'library_ms': None},
        {'name': 'flow_train_fwd', 'route': 'cuda',
         'source': csrc + 'flow_train_fwd.cu',
         'replaces': 'glow_tts_tpu/ops/coupling_grad.py:97',
         'entry': 'fused_flow_stack_train', **launches('train_fwd'),
         'max_abs_err': fwd_err, 'one_pass_max_rel_err': fwd_one_pass,
         **fwd_times, 'library_ms': None},
        # one backward call per flow step: this source's kernels, on what
        # the forward pass stored (no recompute at this shape)
        {'name': 'flow_train_bwd', 'route': 'cuda',
         'source': csrc + 'flow_train_bwd.cu',
         'replaces': 'glow_tts_tpu/ops/coupling_grad.py:195',
         'entry': 'fused_flow_stack_train (backward)',
         **launches('train_bwd'),
         'recompute_launches': sum(counts['train_recompute']
                                   for counts in by_path.values()),
         'max_abs_err': bwd_err, **bwd_times, 'library_ms': None},
        # GR mode's pitch operand: each flow kernel's build with GLOW_PITCH
        *({'name': f'{name}_pitch', 'route': 'cuda',
           'source': csrc + f'{name}.cu', 'build': '-DGLOW_PITCH',
           'replaces': replaces, 'entry': entry,
           **launches(f'{name}_pitch'), **pitch_rows[name],
           'library_ms': None}
          for name, replaces, entry in (
              ('flow_step', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_flow_step'),
              ('coupling', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_coupling'),
              ('flow_stack', 'glow_tts_tpu/ops/coupling.py:296',
               'fused_flow_stack'))),
        # and of the train pair: per flow step, the forward storing
        *({'name': f'{name}_pitch', 'route': 'cuda',
           'source': csrc + f'{name}.cu', 'build': '-DGLOW_PITCH',
           'replaces': replaces, 'entry': entry,
           **launches(f'{counter}_pitch'), **train_pitch_rows[name],
           'library_ms': None}
          for name, counter, replaces, entry in (
              ('flow_train_fwd', 'train_fwd',
               'glow_tts_tpu/ops/coupling_grad.py:97',
               'fused_flow_stack_train'),
              ('flow_train_bwd', 'train_bwd',
               'glow_tts_tpu/ops/coupling_grad.py:195',
               'fused_flow_stack_train (backward)'))),
        # MiniSpeech's 80 flow channels: each flow kernel's build with
        # GLOW_CHANNELS=80
        *({'name': f'{name}_c80', 'route': 'cuda',
           'source': csrc + f'{name}.cu', 'build': '-DGLOW_CHANNELS=80',
           'replaces': replaces, 'entry': entry,
           **launches(f'{counter}_c80'), **minispeech_rows[name],
           'library_ms': None}
          for name, counter, replaces, entry in (
              ('flow_step', 'flow_step', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_flow_step'),
              ('coupling', 'coupling', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_coupling'),
              ('flow_stack', 'flow_stack',
               'glow_tts_tpu/ops/coupling.py:296', 'fused_flow_stack'),
              ('flow_train_fwd', 'train_fwd',
               'glow_tts_tpu/ops/coupling_grad.py:97',
               'fused_flow_stack_train'),
              ('flow_train_bwd', 'train_bwd',
               'glow_tts_tpu/ops/coupling_grad.py:195',
               'fused_flow_stack_train (backward)'))),
        # the bfloat16 builds (GLOW_BF16): 160 channels, the pitch builds,
        # 80 channels
        *({'name': f'{name}_bf16{tag}', 'route': 'cuda',
           'source': csrc + f'{name}.cu',
           'build': ' '.join(f'-D{d}' for d in defines),
           'replaces': replaces, 'entry': entry,
           **launches(f'{counter}_bf16{tag}'),
           **bf16_rows[name + tag], **ring_body(name, defines),
           # both directions on the decode and the eval batch's shapes,
           # each beside its bound (the bf16 routes phase)
           **({'shapes': routes_rows[f'{name}_bf16{tag}']}
              if name == 'flow_step' else {}),
           'library_ms': None}
          for tag, defines in (
              ('', ('GLOW_BF16',)), ('_pitch', ('GLOW_PITCH', 'GLOW_BF16')),
              ('_c80', ('GLOW_CHANNELS=80', 'GLOW_BF16')))
          for name, counter, replaces, entry in (
              ('flow_step', 'flow_step', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_flow_step'),
              ('flow_train_fwd', 'train_fwd',
               'glow_tts_tpu/ops/coupling_grad.py:97',
               'fused_flow_stack_train'),
              ('flow_train_bwd', 'train_bwd',
               'glow_tts_tpu/ops/coupling_grad.py:195',
               'fused_flow_stack_train (backward)'))),
        # the bfloat16 builds of #2 and #4: 160 channels, the pitch builds,
        # 80 channels
        *({'name': f'{name}_bf16{tag}', 'route': 'cuda',
           'source': csrc + f'{name}.cu',
           'build': ' '.join(f'-D{d}' for d in defines),
           'replaces': replaces, 'entry': entry,
           **launches(f'{name}_bf16{tag}'),
           **routes_rows[f'{name}_bf16{tag}'], **ring_body(name, defines),
           'library_ms': None}
          for tag, defines in (
              ('', ('GLOW_BF16',)), ('_pitch', ('GLOW_PITCH', 'GLOW_BF16')),
              ('_c80', ('GLOW_CHANNELS=80', 'GLOW_BF16')))
          for name, replaces, entry in (
              ('coupling', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_coupling'),
              ('flow_stack', 'glow_tts_tpu/ops/coupling.py:296',
               'fused_flow_stack'))),
        # GR at Num_Squeeze 1: the 80-channel pitch builds of every flow
        # source (the pitch operand 1 wide), at f32 and at bf16
        *({'name': f'{name}{tag}', 'route': 'cuda',
           'source': csrc + f'{name}.cu',
           'build': ' '.join(f'-D{d}' for d in defines),
           'replaces': replaces, 'entry': entry,
           **launches(f'{counter}{tag}'), **squeeze1_rows[f'{name}{tag}'],
           **ring_body(name, defines), 'library_ms': None}
          for tag, defines in (
              ('_c80_pitch', ('GLOW_PITCH', 'GLOW_CHANNELS=80')),
              ('_bf16_c80_pitch', ('GLOW_PITCH', 'GLOW_CHANNELS=80',
                                   'GLOW_BF16')))
          for name, counter, replaces, entry in (
              ('flow_step', 'flow_step', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_flow_step'),
              ('coupling', 'coupling', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_coupling'),
              ('flow_stack', 'flow_stack',
               'glow_tts_tpu/ops/coupling.py:296', 'fused_flow_stack'),
              ('flow_train_fwd', 'train_fwd',
               'glow_tts_tpu/ops/coupling_grad.py:97',
               'fused_flow_stack_train'),
              ('flow_train_bwd', 'train_bwd',
               'glow_tts_tpu/ops/coupling_grad.py:195',
               'fused_flow_stack_train (backward)'))),
        # ROADMAP B.2: every flow kernel at other decoder shapes, each a
        # build of its own at the dtypes the B.2 phase runs it (the train
        # pair's rows per flow step, the forward storing), its launches on
        # its build's counters (named by coupling.build_tag)
        *({'name': f'{name}{tag}', 'route': 'cuda',
           'source': csrc + f'{name}.cu',
           'build': ' '.join(f'-D{d}' for d in defines) or '(shipped)',
           'shape': dict(zip(('channels', 'ch', 'n_layers', 'kernel_size'),
                             shape), pitch_size=ps),
           'replaces': replaces, 'entry': entry,
           **launches(counter + build_suffix(channels=shape, pitch=ps,
                                             bf16=bf16)),
           **b2_rows[f'{name}{tag}'],
           **ring_body(name, defines), 'library_ms': None}
          for label, (shape, ps) in B2_SHAPES.items()
          for bf16 in (False, True)
          for tag, defines in [(('_bf16_' if bf16 else '_') + label,
                                coupling.build_defines(shape, ps, bf16))]
          for name, counter, replaces, entry in (
              ('flow_step', 'flow_step', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_flow_step'),
              ('coupling', 'coupling', 'glow_tts_tpu/ops/coupling.py:190',
               'fused_coupling'),
              ('flow_stack', 'flow_stack',
               'glow_tts_tpu/ops/coupling.py:296', 'fused_flow_stack'),
              ('flow_train_fwd', 'train_fwd',
               'glow_tts_tpu/ops/coupling_grad.py:97',
               'fused_flow_stack_train'),
              ('flow_train_bwd', 'train_bwd',
               'glow_tts_tpu/ops/coupling_grad.py:195',
               'fused_flow_stack_train (backward)'))
          if ('bfloat16' if bf16 else 'float32')
          in b2_builds(label).get(counter, ()))]}))
    print(f'chip_smoke: {time.perf_counter() - begun:.0f} s in all, the '
          f'kernels\' build included; by phase {json.dumps(phases)}')
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--data-parallel-rank']:
        data_parallel_rank(*sys.argv[2:4])
    else:
        main()
