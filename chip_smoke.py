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
and an evaluation are timed.  Exits
non-zero on any failure and when no CUDA device is present; the last line
is one JSON object naming the card.
"""

import copy
import dataclasses
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
            'train_recompute', 'train_bwd')
# the deterministic decoder's routes (``config.coupling_backend``): the
# counter of the kernel each goes through
ROUTES = {'fused': 'flow_step', 'modules': 'coupling', 'mega': 'flow_stack'}


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
        (flow_stack_train, 'backward_launches'))))


def route_launches(route, config, passes=1):
    """The flow launches of ``passes`` decoder passes under ``route``: one
    per flow step, or one in all under ``'mega'``; every other count 0."""
    per_pass = 1 if route == 'mega' else config.decoder.stack
    return {**dict.fromkeys(COUNTERS, 0), ROUTES[route]: per_pass * passes}


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
            for key in (*COUPLING_WEIGHT_KEYS, *TC_KEYS.values())}


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


def time_flow_kernels(model, device, eval_mask):
    """Kernels #3, #2 and #4 and their plain versions at B = 32, T = 512,
    both directions, each beside its bounds, with all frames valid and on
    the eval step's ragged mask ``eval_mask`` (the squeezed training batch),
    with the live tiles and rounds each kernel reports at both shapes; #3
    also at one TF32 pass; and the reverse stack three ways at both shapes:
    12 flow-step launches, the same launches replayed from a CUDA graph,
    and kernel #4's one launch, with the time of a round of each."""
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
    x, mask = ragged_batch(torch.Generator().manual_seed(SEED + 3),
                           32, 512, c, device)
    mask = torch.ones_like(mask)
    # the same inputs on the eval step's ragged batch: live tiles only
    xe = x[:, :eval_mask.shape[1]].contiguous() * eval_mask
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
    for reverse in (True, False):
        one_ms = cuda_ms(lambda: _flow_step_kernel(
            x, mask, step.weights(reverse), cond, reverse, passes=1), 20)
        key = 'ms' if reverse else 'forward_ms'
        flow_times[f'one_pass_{key}'] = one_ms
        print(f'flow step B=32 T=512 reverse={reverse}, one TF32 pass: '
              f'kernel {one_ms:.4f} ms (3xTF32 {flow_times[key]:.4f} ms)')
    flow_times['schedule'] = schedules(
        'flow step', lambda xs, m, tiles: _flow_step_kernel(
            xs, m, weights, cond, False, tiles=tiles),
        load_flow_step_library().glow_flow_step_resident_blocks)

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
        load_coupling_library().glow_coupling_resident_blocks)

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
        load_flow_stack_library().glow_flow_stack_resident_blocks,
        steps=n_steps, stack=True)

    # the reverse stack as a decode runs it, three ways on the same input,
    # at both shapes; a round is one tile's step on every block
    packs = [(s.weights(True), s.cond(32)) for s in reversed(flows)]
    for shape, (xs, m) in shapes.items():
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


def profile_window(label, fn, repeats, warmup=2):
    """One ``torch.profiler`` window over ``repeats`` calls of ``fn``:
    device time by kernel, and the share of the window in which the device
    is idle."""
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
        return
    print(f'profiler window, {repeats} {label}: wall {wall_ms:.2f} ms, '
          f'{sum(count for _, count, _ in rows)} kernels busy {busy_ms:.2f} ms '
          f'(device idle {100 * (1 - busy_ms / wall_ms):.1f} % of the window)')
    for ms, count, key in rows[:10]:
        print(f'  {ms:9.3f} ms  {count:5d} x  {key[:90]}')


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

    def fn(x, mask, weights, seed, dropout_rate):
        return coupling_grad._apply_kernels(x, mask, weights, None, seed,
                                            dropout_rate, route, passes)
    return fn


def check_train_backward(x, mask, weights):
    """Kernel #6 against autograd of the plain version: dx and every
    weight gradient of a loss through z and the logdet, under both routes
    (activations stored by the forward pass, and recomputed step by step);
    the two routes bit-equal, and two runs of each; the last layer's
    residual-half gradient exactly zero; and the error of one TF32 pass
    beside that of the shipped product."""
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    gen = torch.Generator().manual_seed(SEED + 5)
    dz = torch.randn(x.shape, generator=gen).to(x.device)
    dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(x.device)

    def gradients(fn):
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = x.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, seed=SEED + 6, dropout_rate=FLOW_RATE)
        (torch.sum(z * dz) + torch.sum(ld * dld)).backward()
        torch.cuda.synchronize()
        return {'x': xl.grad, **{key: leaf.grad
                                 for key, leaf in leaves.items()}}

    s_steps, n, _, ch, _ = weights['w_in'].shape
    b, t, c = x.shape
    chosen = ('store' if coupling_grad.stores_activations(
        s_steps, b * t, c, ch, n) else 'recompute')
    zero_counts()
    got = gradients(flow_stack_train)
    counts = read_counts()
    expected = {'train_fwd': s_steps,
                'train_recompute': 0 if chosen == 'store' else s_steps,
                'train_bwd': BWD_KERNELS_PER_FLOW_STEP * s_steps}
    assert {key: counts[key] for key in expected} == expected, counts
    runs = {route: [gradients(forced_route(route)) for _ in range(2)]
            for route in ('store', 'recompute')}
    ref = gradients(flow_stack_train_reference)
    one_pass = gradients(forced_route(chosen, passes=1))
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
    print(f'train backward kernel vs autograd of plain {tuple(x.shape)}, '
          f'rate {FLOW_RATE}: worst gradient rel err {worst_rel:.3e} of '
          f'its tensor\'s max-abs (bar {GRAD_REL_BOUND:.0e}); route '
          f'{chosen!r} by the shapes, {BWD_KERNELS_PER_FLOW_STEP} launches '
          f'of the backward library per flow step; stored and recomputed '
          f'routes bit-equal, two runs of each bit-equal; last layer\'s '
          f'residual-half gradient exactly 0')
    print('  ' + ', '.join(lines))
    print(f'backward GEMM precision: {coupling_grad.TF32_PASSES}xTF32 '
          f'shipped, worst gradient rel err {worst_rel:.3e}; 1xTF32 '
          f'{worst_one:.3e} (bar {GRAD_REL_BOUND:.0e})')
    return worst_abs


def run_training(config, batch, device):
    """The train path: ActNorm's data-dependent init, then ``TRAIN_STEPS``
    train steps, through the kernels and, from the same initial weights,
    seed and generator state, through the plain versions."""
    from glow_tts_tpu_torch import (initial_state_dict, make_eval_step,
                                    make_optimizer, make_train_step)
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    state = initial_state_dict(config, SEED)
    runs = {}
    for name, step_fn, stack_fn, mas_fn in (
            ('kernels', flow_step, flow_stack_train, maximum_path),
            ('plain', flow_step_reference, flow_stack_train_reference,
             maximum_path_reference)):
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
                                  step_fn=step_fn)
        init_counts = read_counts()
        before = eval_step(batch)[0]['total'].item()
        zero_counts()
        metrics = [train_step(batch) for _ in range(TRAIN_STEPS)]
        step_counts = read_counts()
        if name == 'kernels':
            launches = {key: init_counts[key] + step_counts[key]
                        for key in step_counts}
        after = eval_step(batch)[0]['total'].item()
        runs[name] = ([{key: value.item() for key, value in m.items()}
                       for m in metrics], before, after)

    steps = config.decoder.stack
    print(f'train path, {TRAIN_STEPS} steps after the data-dependent init: '
          f'launches {launches} ({steps} forward, no recompute (the forward '
          f'stores), {steps} x {BWD_KERNELS_PER_FLOW_STEP} backward kernels '
          f'and 1 MAS expected per step, {steps} flow steps for the init)')
    assert launches == {
        **dict.fromkeys(COUNTERS, 0), 'flow_step': steps, 'mas': TRAIN_STEPS,
        'train_fwd': steps * TRAIN_STEPS,
        'train_bwd': BWD_KERNELS_PER_FLOW_STEP * steps * TRAIN_STEPS}, launches
    for i, (k, p) in enumerate(zip(runs['kernels'][0], runs['plain'][0])):
        print(f'  step {i}: kernels total {k["total"]:.6f} mle '
              f'{k["mle"]:.6f} duration {k["duration"]:.6f} grad_norm '
              f'{k["grad_norm"]:.5f}; plain total {p["total"]:.6f} mle '
              f'{p["mle"]:.6f} duration {p["duration"]:.6f} grad_norm '
              f'{p["grad_norm"]:.5f}')
        for key, bar in (('total', TRAIN_LOSS_REL_BOUND),
                         ('mle', TRAIN_LOSS_REL_BOUND),
                         ('duration', TRAIN_LOSS_REL_BOUND),
                         ('grad_norm', TRAIN_NORM_REL_BOUND)):
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


def time_training(config, batch, x, mask, weights, device):
    """The train step with kernels and with plain versions, its parts each
    alone, the bounds of kernels #5 and #6 from this run's shapes, and a
    profiler window over train steps."""
    from glow_tts_tpu_torch import (make_optimizer, make_train_step,
                                    random_state_dict)
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops import coupling_grad
    from glow_tts_tpu_torch.ops.coupling_grad import (
        flow_stack_train, flow_stack_train_reference)
    from glow_tts_tpu_torch.ops.mas import maximum_path_reference
    state = random_state_dict(config, SEED)

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

    model, optimizer, step_k = stepper()
    _, _, step_p = stepper(flow_stack_train_reference, maximum_path_reference)
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
            ('kernel, recompute route', forced_route('recompute'), 3),
            ('kernel, stored, 1xTF32', forced_route('store', passes=1), 3),
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
    print(f'  per flow step: forward {flops / k_fwd / 1e9:.2f} TFLOP/s on '
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
    time_backward_gemms(device)

    # the other parts of a train step, each alone
    tokens = batch['tokens']
    token_mask = sequence_mask(batch['token_lengths'], tokens.shape[1])
    encoder = model.layer_Dict['Encoder']
    decoder = model.layer_Dict['Decoder']
    enc_gen = torch.Generator(device=device).manual_seed(SEED)

    def encoder_both():
        outs = encoder(tokens, token_mask, False, enc_gen)
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


def write_archive(path, n, config, seed):
    """``n`` patterns with the port's pattern IO, as ``synthetic_items``
    makes a batch's items: texts of 10 … 200 characters, mels of 50 … 1000
    frames uniform in [−max_abs_mel, max_abs_mel]."""
    from glow_tts_tpu_torch.data.patterns import (build_metadata,
                                                  save_metadata, save_pattern)
    rng = np.random.default_rng(seed)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    a = config.sound.max_abs_mel
    for i, (n_text, n_mel) in enumerate(zip(
            rng.permutation(np.linspace(10, MAX_TOKENS, n).round()),
            rng.permutation(np.linspace(50, MAX_FRAMES, n).round()))):
        chars = rng.choice(letters, int(n_text))
        chars[5::6] = ' '
        mel = rng.uniform(-a, a, (int(n_mel), config.sound.mel_dim))
        save_pattern(os.path.join(path, f'P{i:03d}.PICKLE'), {
            'Audio': np.zeros(int(n_mel), np.float32),
            'Mel': mel.astype(np.float32),
            'Pitch': np.zeros(int(n_mel), np.float32), 'Speaker_ID': 0,
            'Speaker': 'Synthetic', 'Dataset': 'Synthetic',
            'Text': ''.join(chars)})
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


def trainer_config(config, root, run, max_step):
    from glow_tts_tpu_torch.config import PatternConfig
    train = dataclasses.replace(
        config.train, max_step=max_step, checkpoint_save_interval=SAVE_EVERY,
        logging_interval=SAVE_EVERY, evaluation_interval=EVAL_EVERY,
        inference_interval=EVAL_EVERY,
        train_pattern=PatternConfig(path=os.path.join(root, 'train')),
        eval_pattern=PatternConfig(path=os.path.join(root, 'eval')),
        inference_pattern_file_in_train=os.path.join(root, 'sentences.tsv'))
    return dataclasses.replace(
        config, train=train,
        checkpoint_path=os.path.join(root, run, 'checkpoint'),
        log_path=os.path.join(root, run, 'log'),
        inference_path=os.path.join(root, run, 'inference'))


def new_trainer(config, root, run, max_step, device, counts=None):
    """A ``Trainer`` with a recording writer pair; with ``counts``, its
    construction (ActNorm's init), train steps, eval steps, free-running
    decodes and inference runs counted by part."""
    from glow_tts_tpu_torch import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    make = lambda: Trainer(  # noqa: E731
        trainer_config(config, root, run, max_step), device=device,
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


def compare_runs(a, b):
    """B against A by group (the final parameters, each optimiser moment,
    the logged train and eval losses after the restore): the largest
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
                                if step > RESUME_STEP]),
             torch.tensor([v for step, v in logged[tag]
                           if step > RESUME_STEP]))
            for tag, values in a.writers[kind].scalars.items()
            if tag.startswith('Loss/')]
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
    sources = {'flow_step.cu': coupling.load_flow_step_library,
               'coupling.cu': coupling.load_coupling_library,
               'flow_stack.cu': coupling.load_flow_stack_library,
               'mas.cu': mas.load_mas_library,
               'flow_train_fwd.cu': coupling_grad.load_train_forward_library,
               'flow_train_bwd.cu': coupling_grad.load_train_backward_library}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc each, together
        for build in [pool.submit(load) for load in sources.values()]:
            build.result()
    print(f'{len(sources)} kernel libraries built and loaded in '
          f'{time.perf_counter() - start:.1f} s')
    for source in sources:
        for line in cuda_build.ptxas_report(source):
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
    by_path.update(run_trainer_phase(config, device, card))

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
         'max_abs_err': bwd_err, **bwd_times, 'library_ms': None}]}))
    print(f'chip_smoke: {time.perf_counter() - begun:.0f} s in all, the '
          f'kernels\' build included')
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
