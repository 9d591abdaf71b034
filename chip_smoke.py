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
``Trainer`` 10 steps on those patterns (#1, #5, #6 at 80 channels) and a
checkpoint, served through ``Inferencer`` with the Griffin-Lim export
twice (the wavs read back, bit-equal), Griffin-Lim on the card against
the CPU, SE-GE2E, PE and GR at the shipped width served from reference-wav
features made on the card (held against the CPU's), and the DSP and the
export timed.  Exits non-zero on any failure and when no CUDA device is
present; the last line is one JSON object naming the card.
"""

import copy
import dataclasses
import functools
import json
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
FED_STEPS = 6              # the data-fed loop, after one warm-up step
TIMING_BATCHES = 8         # its archive's batches an epoch: a run in one
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


def live_tiles(mask, launch, steps=1, stack=False):
    """What ``launch(tiles)`` reports from the card into ``tiles``
    (``coupling.TILE_COUNTS``: the list's live and all items, the live
    items computed, the rounds, the grid's blocks), held against the Python
    twin of its schedule: ``steps`` launches over the live tiles of the
    mask [B, T, 1] (``live_tile_schedule``), or, with ``stack``, the one
    launch over ``steps`` flow steps (``stack_tile_schedule``)."""
    from glow_tts_tpu_torch.ops import coupling
    tiles = coupling.tile_report(mask.device)
    launch(tiles)
    got = dict(zip(coupling.TILE_COUNTS, tiles.tolist()))
    lengths = coupling.valid_lengths(mask).tolist()
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


COUNTERS = ('flow_step', 'coupling', 'flow_stack', 'mas', 'train_fwd',
            'train_recompute', 'train_bwd', 'flow_step_pitch',
            'coupling_pitch', 'flow_stack_pitch', 'train_fwd_pitch',
            'train_recompute_pitch', 'train_bwd_pitch', 'flow_step_c80',
            'coupling_c80', 'flow_stack_c80', 'train_fwd_c80',
            'train_recompute_c80', 'train_bwd_c80')
# the deterministic decoder's routes (``config.coupling_backend``): the
# counter of the kernel each goes through
ROUTES = {'fused': 'flow_step', 'modules': 'coupling', 'mega': 'flow_stack'}
# and of its pitch instantiation (GR mode with a pitch track)
PITCH_ROUTES = {route: f'{counter}_pitch' for route, counter in ROUTES.items()}


def launch_counters():
    """(function, attribute) of every kernel launch count of the port."""
    from glow_tts_tpu_torch.ops.coupling import coupling, flow_stack, flow_step
    from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
    from glow_tts_tpu_torch.ops.mas import maximum_path
    return dict(zip(COUNTERS, (
        (flow_step, 'launches'), (coupling, 'launches'),
        (flow_stack, 'launches'), (maximum_path, 'launches'),
        (flow_stack_train, 'forward_launches'),
        (flow_stack_train, 'recompute_launches'),
        (flow_stack_train, 'backward_launches'),
        (flow_step, 'pitch_launches'), (coupling, 'pitch_launches'),
        (flow_stack, 'pitch_launches'),
        (flow_stack_train, 'forward_pitch_launches'),
        (flow_stack_train, 'recompute_pitch_launches'),
        (flow_stack_train, 'backward_pitch_launches'),
        (flow_step, 'c80_launches'), (coupling, 'c80_launches'),
        (flow_stack, 'c80_launches'),
        (flow_stack_train, 'forward_c80_launches'),
        (flow_stack_train, 'recompute_c80_launches'),
        (flow_stack_train, 'backward_c80_launches'))))


def route_launches(route, config, passes=1, pitch=False):
    """The flow launches of ``passes`` decoder passes under ``route``: one
    per flow step, or one in all under ``'mega'``, of the pitch
    instantiation with ``pitch`` (of the 80-channel build at
    ``Num_Squeeze: 1``); every other count 0."""
    per_pass = 1 if route == 'mega' else config.decoder.stack
    counter = (PITCH_ROUTES if pitch else ROUTES)[route] + build_suffix(
        config)
    return {**dict.fromkeys(COUNTERS, 0), counter: per_pass * passes}


def build_suffix(config=None, channels=None):
    """The suffix of the counters of the flow builds ``config`` (or a flow
    of ``channels`` channels) runs through: '' at the shipped 160, '_c80'
    at MiniSpeech's 80."""
    if channels is None:
        channels = config.sound.mel_dim * config.decoder.num_squeeze
    return '' if channels == 160 else f'_c{channels}'


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
    tensor-core layout."""
    from glow_tts_tpu_torch.ops.coupling import COUPLING_WEIGHT_KEYS, TC_KEYS
    return {key: weights[key]
            for key in (*COUPLING_WEIGHT_KEYS, *TC_KEYS.values())
            if key in weights}


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


def check_train_forward(x, mask, weights):
    """Kernel #5 against the plain version, the whole stack, at dropout
    rate 0.05 and 0 with the same (negative) seed; and the kernel's masks
    read element by element through a probe stack whose pre-gate sum is the
    keep factor itself."""
    from glow_tts_tpu_torch.ops import dropmask
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

        # the masks: with w_in = 0 and b_in = 1 the pre-gate sum is the keep
        # factor, so a dropped element has tanh 0 and sigmoid 1/2 in what
        # the backward pass's recompute leaves of the gate; under a mask of
        # ones every tile is live, so every element is drawn
        probe = dict(weights, w_in=torch.zeros_like(weights['w_in']),
                     b_in=torch.ones_like(weights['b_in']))
        s_steps, n, k, ch, ch2 = weights['w_in'].shape
        b, t, c = x.shape
        step = s_steps - 5
        saved = coupling_grad._saved_buffers(b * t, c, ch, n, x.device)
        coupling_grad._recompute(
            x, torch.ones_like(mask), None,
            coupling_grad._kernel_weights(
                [probe[key] for key in coupling_grad.WEIGHT_KEYS]),
            saved, step, coupling_grad._dropout_args(seed, FLOW_RATE))
        ts = saved['ts']
        kept_kernel = torch.cat([ts[..., :ch] != 0, ts[..., ch:] != 0.5],
                                dim=-1).reshape(n, b, t, ch2)
        kept_plain = torch.stack([
            dropmask.stack_mask(seed, step, i, n, b, t, k, ch2, FLOW_RATE,
                                x.device) != 0 for i in range(n)])
        differing = (kept_kernel != kept_plain).sum().item()
        dropped = 1.0 - kept_plain.float().mean().item()
        print(f'dropout masks of flow step {step}, kernel vs plain: '
              f'{differing} differing elements of {kept_plain.numel()} '
              f'({100 * dropped:.3f} % dropped at rate {FLOW_RATE})')
        assert differing == 0
        assert abs(dropped - FLOW_RATE) < 2e-3
    return worst, one_pass


def forced_route(route, passes=None):
    """``flow_stack_train``'s kernels with the forward pass's route
    (``'store'`` or ``'recompute'``) and the backward GEMMs' TF32 passes
    forced, through the wrapper's private entry."""
    from glow_tts_tpu_torch.ops import coupling_grad
    passes = passes or coupling_grad.TF32_PASSES

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
    build = ('_pitch' if pitch is not None
             else build_suffix(channels=x.shape[-1]))
    per_step = (BWD_KERNELS_PER_FLOW_STEP if pitch is None
                else BWD_PITCH_KERNELS_PER_FLOW_STEP)
    zero_counts()
    got = gradients(flow_stack_train)
    counts = read_counts()
    expected = {**dict.fromkeys(COUNTERS, 0), f'train_fwd{build}': s_steps,
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
    if config.uses_gradient_reversal:
        return {**dict.fromkeys(COUNTERS, 0), 'flow_step_pitch': flows,
                'mas': steps, 'train_fwd_pitch': flows * steps,
                'train_bwd_pitch': BWD_PITCH_KERNELS_PER_FLOW_STEP * flows
                * steps}
    build = build_suffix(config)
    return {**dict.fromkeys(COUNTERS, 0), f'flow_step{build}': flows,
            'mas': steps, f'train_fwd{build}': flows * steps,
            f'train_bwd{build}': BWD_KERNELS_PER_FLOW_STEP * flows * steps}


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
                               iters=3, plain_iters=1, plain_warmup=1)
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
    profile_window('train steps', lambda: step_k(batch), 5, warmup=2)
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
        total = self.by_part.setdefault(part, dict.fromkeys(COUNTERS, 0))
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
            assert got == {**dict.fromkeys(COUNTERS, 0), **want}, (part, got)

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


def mode_config(mode, route='fused'):
    """The shipped YAML in ``mode`` (``'SE-LUT'``, ``'SE-GE2E'``, ``'PE'``,
    ``'GR'``) under ``route``."""
    import yaml
    from glow_tts_tpu_torch import load_config
    with open(CONFIG, encoding='utf-8') as f:
        data = yaml.safe_load(f)
    data['Mode'] = mode.split('-')[0]
    if mode == 'SE-GE2E':
        data['Speaker_Embedding']['Type'] = 'GE2E'
    return dataclasses.replace(load_config(data), coupling_backend=route)


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
        PITCH_SIZE, WEIGHT_KEYS, coupling, coupling_reference, flow_stack,
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
    pitch = torch.rand((GR_BATCH, 512, PITCH_SIZE), generator=gen).to(device)
    xe = (x[:, :eval_mask.shape[1]] * eval_mask).contiguous()
    shapes = {'decode': (x, torch.ones_like(x[..., :1])),
              'eval': (xe, eval_mask)}
    stacked = {r: decoder.stacked_weights(r) for r in (False, True)}
    own = {**coupling_weights(step.weights(False)),
           'w_pitch': step.weights(False)['w_pitch']}
    n, ch2 = own['w_pitch'].shape[0], own['w_pitch'].shape[-1]
    pitch_flops = 2 * PITCH_SIZE * ch2 * n          # a frame and step

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
    from glow_tts_tpu_torch.ops.coupling import PITCH_SIZE
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
    pitch_flops = 2 * PITCH_SIZE * ch2 * n
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
    gr_ms, vanilla_ms = paired_ms(gr_step, vanilla_step, 3)
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
    idle = profile_window('GR train steps', gr_step, 5)
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
        times[f'{mode}_step_ms'] = cuda_ms(step, 3, 1)
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
        assert train == {**dict.fromkeys(COUNTERS, 0), 'mas': TRAINER_STEPS,
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


def minispeech_config(root):
    """``configs/MiniSpeech.yaml`` with its token dictionary (written here)
    and its outputs under ``root``, and its pattern sets ``root/train``
    and ``root/eval`` (its own length filters).  The YAML asks for bf16:
    the port computes in f32 and says so once per process (A.5)."""
    import warnings

    import yaml
    from glow_tts_tpu_torch import load_config
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        config = load_config(MINISPEECH)
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
            **dict.fromkeys(COUNTERS, 0), 'mas': mas[variant[0]],
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
                                lambda: plain_step(batch), iters=5)
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
                                      lambda: em_step(batch), 3, busy=True)
    plain_idle, plain_busy = profile_window(
        'MiniSpeech learned-prior MAS steps', lambda: plain_step(batch), 3,
        busy=True)
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
        assert got == {**dict.fromkeys(COUNTERS, 0), **want}, (part, got)
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
WAV_TRAIN_STEPS = 10           # the Trainer's steps on the ETL's patterns
WAV_CHECKED = 4                # patterns held against the ETL on the CPU
WAV_EXPORTS = 4                # wavs the Inferencer exports, twice
DSP_MEL_BOUND = 2e-3           # card vs CPU mel, max-abs on the ±4 scale
NEAR_TIE = 1e-5                # a CMND this close to a YIN decision: the
                               # frame's pitch is not held (and counted)
GL_ONE_REL_BOUND = 1e-4        # Griffin-Lim card vs CPU, 1 iteration
GL_SC_REL_BOUND = 0.02         # and the spectral convergence after 60
GL_FRAMES = 1024               # the timed Griffin-Lim's mel
REF_MODES = ('SE-GE2E', 'PE', 'GR')


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
        assert got == {**dict.fromkeys(COUNTERS, 0), **want}, (part, got)
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
        config = e2e.minispeech_config(root, WAV_TRAIN_STEPS)
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
    # (source, defines): the six libraries, and the pitch instantiations of
    # #3, #2, #4, #5 and #6 (GR mode) and their 80-channel builds
    # (MiniSpeech) as libraries of their own
    flow_loaders = (('flow_step.cu', coupling.load_flow_step_library),
                    ('coupling.cu', coupling.load_coupling_library),
                    ('flow_stack.cu', coupling.load_flow_stack_library),
                    ('flow_train_fwd.cu',
                     coupling_grad.load_train_forward_library),
                    ('flow_train_bwd.cu',
                     coupling_grad.load_train_backward_library))
    sources = {('flow_step.cu', ()): coupling.load_flow_step_library,
               ('coupling.cu', ()): coupling.load_coupling_library,
               ('flow_stack.cu', ()): coupling.load_flow_stack_library,
               ('mas.cu', ()): mas.load_mas_library,
               ('flow_train_fwd.cu', ()):
                   coupling_grad.load_train_forward_library,
               ('flow_train_bwd.cu', ()):
                   coupling_grad.load_train_backward_library,
               **{(source, coupling.PITCH_BUILD): functools.partial(load, True)
                  for source, load in flow_loaders},
               **{(source, coupling.build_defines(80)):
                  functools.partial(load, channels=80)
                  for source, load in flow_loaders}}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each, together
        for build in [pool.submit(load) for load in sources.values()]:
            build.result()
    print(f'{len(sources)} kernel libraries built and loaded in '
          f'{time.perf_counter() - start:.1f} s')
    for source, defines in sources:
        for line in cuda_build.ptxas_report(source, defines):
            print(f'  ptxas {line}')

    config = load_config(CONFIG)
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

    flow_times, coupling_times, stack_times = time_flow_kernels(
        inferencer.model, device, mask)
    time_routes(inferencers, models, prior_1024, batches[0])
    mas_times, eval_step = time_eval(model, batches[0], config, device)
    fwd_times, bwd_times = time_training(config, batches[0], x, mask,
                                         weights, device)
    profile_window('eval steps', lambda: eval_step(batches[0]), 3)
    # the conditioned modes: GR's pitch instantiations, serving, the forward
    pitch_rows, conditioned_paths = run_conditioned_phase(
        {route: inferencers[route].model for route in ROUTES}, batches[0],
        mask, device)
    by_path.update(conditioned_paths)
    # training the conditioned modes: #5's and #6's pitch builds, GR, SE, PE
    train_pitch_rows, conditioned_paths = run_conditioned_training(config,
                                                                  device)
    by_path.update(conditioned_paths)
    # MiniSpeech, the converged recipe: the 80-channel builds, the
    # curriculum and its trainer
    minispeech_rows, minispeech_paths = run_minispeech_phase(device, card)
    by_path.update(minispeech_paths)
    by_path.update(run_trainer_phase(config, device, card))
    # from wavs to wavs: the ETL, the export and the reference-wav features
    by_path.update(run_wav_phase(device, card))

    def launches(counter):
        paths = {path: counts[counter] for path, counts in by_path.items()}
        assert sum(paths.values()) > 0, f'{counter}: launched on no path'
        return {'launches': sum(paths.values()), 'launches_by_path': paths}

    csrc = 'glow_tts_tpu_torch/csrc/'
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
               'fused_flow_stack_train (backward)')))]}))
    print(f'chip_smoke: {time.perf_counter() - begun:.0f} s in all, the '
          f'kernels\' build included')
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
