#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``glow_tts_tpu_torch/csrc`` (the flow step and
the monotonic alignment search), holds each against its plain PyTorch
version at the shipped width, and drives two paths through them at
``configs/Hyper_Parameters.yaml`` width with random weights from a seed:
Vanilla serving (``Inferencer``, two mel buckets) and the loss/eval path
(a from-scratch model, ActNorm's data-dependent initialisation on a batch
from ``TrainCollater``, then ``eval_step``).  Times kernel and plain
versions with CUDA events.  Exits non-zero on any failure and when no CUDA
device is present; the last line is one JSON object naming the card.
"""

import copy
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
# the training shape of the shipped config: Train.Batch_Size 32, up to 200
# tokens and 1000 mel frames, padded to the 32-token and 128-frame buckets
EVAL_BATCH, MAX_TOKENS, MAX_FRAMES = 32, 200, 1000
EVAL_TOKENS, EVAL_FRAMES = 224, 1024       # the padded axes of such a batch
# published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


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


def bound(bytes_moved: float, flops: float):
    """The least time in ms the card could take: each input read once and
    each output written once at the memory rate, or the operations at the
    f32 rate, whichever is longer; and which of the two it is."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops else 'operations'


def ragged_batch(gen, b, t, c, device):
    lengths = torch.linspace(1, t, b).round().long()
    lengths[0], lengths[-1] = 1, t
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = torch.randn((b, t, c), generator=gen) * mask
    return x.to(device), mask.to(device)


def check_kernel(model, device):
    """The kernel against its plain version at full width, both
    directions, ragged lengths (1 … T), T = 512 and an odd T."""
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    gen = torch.Generator().manual_seed(SEED + 1)
    worst = 0.0
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
        z, _ = flow_step(x, mask, step.weights(False), cond, False)
        back, _ = flow_step(z, mask, step.weights(True), cond, True)
        trip = ((back - x).abs().max() / x.abs().max()).item()
        print(f'kernel round trip T={t}: max rel err {trip:.3e}')
        assert trip < ROUNDTRIP_BOUND
    return worst


def serve(inferencer, config):
    """The main path: text requests → Inferencer → mels, in two buckets."""
    from glow_tts_tpu_torch.ops.coupling import flow_step
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
    flow_step.launches = 0
    results = inferencer.inference(list(labels), list(texts), list(scales),
                                   seed=SEED)
    torch.cuda.synchronize()
    launches = flow_step.launches
    per_decode = config.decoder.stack
    print(f'served {len(results)} requests in {n_decodes} decodes: '
          f'flow-step kernel launches {launches} '
          f'({per_decode} expected per decode)')
    assert len(results) == len(requests)
    assert launches == per_decode * n_decodes, launches
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
    return launches


def compare_decode(inferencer, texts, bucket):
    """One batch decoded through the kernel and through the plain version,
    same prior and noise: mel MAE over the valid frames."""
    from glow_tts_tpu_torch.ops.coupling import flow_step_reference
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
                                   step_fn=flow_step_reference)
    valid = (torch.arange(bucket, device=noise.device)[None, :]
             < out_k['mel_lengths'][:, None])[..., None]
    mae = ((out_k['mels'] - out_p['mels']).abs() * valid).sum() \
        / (valid.sum() * noise.shape[-1])
    print(f'decode kernel vs plain (B={len(texts)}, bucket {bucket}): '
          f'mel MAE {mae.item():.3e}')
    assert mae.item() < MEL_MAE_BOUND


def time_all(inferencer, prior_1024, device):
    from glow_tts_tpu_torch.ops.coupling import flow_step, flow_step_reference
    model = inferencer.model
    step = model.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    x, mask = ragged_batch(torch.Generator().manual_seed(SEED + 3),
                           32, 512, c, device)
    mask = torch.ones_like(mask)
    cond = step.cond(32)
    # the step's work from its shapes: 2 FLOP per weight per valid frame
    # (start, n × (k-tap conv + res/skip), end, mixing), every tensor once
    weights = step.weights(False)
    frame_flops = 2 * sum(weights[key].numel() for key in
                          ('w_start', 'w_in', 'w_rs', 'w_end', 'mix_t'))
    flops = frame_flops * mask.sum().item()
    moved = 4 * (2 * x.numel() + mask.numel() + cond.numel() + x.shape[0]
                 + sum(value.numel() for value in weights.values()))
    bound_ms, bound_by = bound(moved, flops)
    times = {}
    for reverse in (True, False):
        w = step.weights(reverse)
        k_ms, p_ms = paired_ms(
            lambda: flow_step(x, mask, w, cond, reverse),
            lambda: flow_step_reference(x, mask, w, cond, reverse), 20)
        print(f'flow step B=32 T=512 reverse={reverse}: kernel {k_ms:.4f} ms '
              f'({flops / k_ms / 1e9:.2f} TFLOP/s at '
              f'{frame_flops / 1e6:.2f} MFLOP/frame), plain {p_ms:.4f} ms; '
              f'bound {bound_ms:.4f} ms by {bound_by}')
        times[reverse] = (k_ms, p_ms)

    gen = torch.Generator(device=device)
    b = prior_1024['durations'].shape[0]
    k_ms, p_ms = paired_ms(
        lambda: model.inference_decode(prior_1024, generator=gen,
                                       max_mel_length=1024),
        lambda: model.inference_decode(prior_1024, generator=gen,
                                       max_mel_length=1024,
                                       step_fn=flow_step_reference), 5)
    print(f'decode phase B={b} bucket 1024: kernel {k_ms:.3f} ms '
          f'({b * 1024 / k_ms * 1e3:.0f} mel frames/s of capacity), '
          f'plain {p_ms:.3f} ms ({b * 1024 / p_ms * 1e3:.0f} mel frames/s)')
    return {'ms': times[True][0], 'plain_ms': times[True][1],
            'forward_ms': times[False][0], 'forward_plain_ms': times[False][1],
            'bound_ms': bound_ms, 'bound_by': bound_by}


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


def check_mas(device):
    """The MAS kernel against its plain version at the training shape:
    every element of the path equal."""
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    log_p, tl, ml = mas_problem(device)
    got = maximum_path(log_p, tl, ml)
    torch.cuda.synchronize()
    expected = maximum_path_reference(log_p, tl, ml)
    differing = (got != expected).sum().item()
    print(f'MAS kernel vs plain {tuple(log_p.shape)}, ragged lengths: '
          f'{differing} differing elements of {got.numel()}')
    assert differing == 0
    check_path(got, tl, ml)
    return float((got - expected).abs().max().item())


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
    from glow_tts_tpu_torch.ops.coupling import flow_step_reference
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
        config, model, step_fn=flow_step_reference,
        mas_fn=recording('plain', maximum_path_reference))(batch)
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


def run_eval(model, batches, config):
    """The loss path: ``eval_step`` on each batch through the kernels."""
    from glow_tts_tpu_torch import attention_diagonality, make_eval_step
    from glow_tts_tpu_torch.ops.coupling import flow_step
    from glow_tts_tpu_torch.ops.mas import maximum_path
    eval_step = make_eval_step(config, model)
    flow_step.launches = maximum_path.launches = 0
    results = [eval_step(batch) for batch in batches]
    torch.cuda.synchronize()
    launches = flow_step.launches, maximum_path.launches
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
    print(f'evaluated {len(batches)} batches: flow-step launches '
          f'{launches[0]} ({config.decoder.stack} expected per batch), '
          f'MAS launches {launches[1]} (1 expected per batch)')
    assert launches == (config.decoder.stack * len(batches), len(batches))
    return launches


def time_eval(model, batch, config, device):
    """MAS kernel vs plain at the training shape; the whole eval step with
    kernels vs with plain versions; and the eval step's parts."""
    from glow_tts_tpu_torch import make_eval_step
    from glow_tts_tpu_torch.models.glow_tts import prior_log_likelihood
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.ops.coupling import flow_step_reference
    from glow_tts_tpu_torch.ops.mas import maximum_path, maximum_path_reference
    from glow_tts_tpu_torch.training.step import compute_losses
    log_p, tl, ml = mas_problem(device)
    k_ms, p_ms = paired_ms(lambda: maximum_path(log_p, tl, ml),
                           lambda: maximum_path_reference(log_p, tl, ml),
                           iters=20, plain_iters=2, plain_warmup=1)
    # what this run's lengths need: the valid part of log_p read once, the
    # whole path written once; per needed cell a max, an add and a compare
    cells = (tl.long() * ml.long()).sum().item()
    moved = 4 * (cells + log_p.numel() + 2 * tl.numel())
    bound_ms, bound_by = bound(moved, 3 * cells)
    print(f'MAS {tuple(log_p.shape)}: kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.2f} ms; bound {bound_ms:.4f} ms by {bound_by} '
          f'({moved / 1e6:.1f} MB; the {int(ml.max())} dependent frames of '
          f'the longest sample hold the kernel, not the bytes)')
    mas_times = {'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': bound_ms,
                 'bound_by': bound_by}

    eval_k = make_eval_step(config, model)
    eval_p = make_eval_step(config, model, step_fn=flow_step_reference,
                            mas_fn=maximum_path_reference)
    k_ms, p_ms = paired_ms(lambda: eval_k(batch), lambda: eval_p(batch),
                           iters=5, plain_iters=2, plain_warmup=1)
    print(f'eval step {tuple(batch["mels"].shape)}: kernels {k_ms:.3f} ms, '
          f'plain versions {p_ms:.2f} ms')

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


def profile_eval(eval_step, batch):
    """One ``torch.profiler`` window over three eval steps: device time by
    kernel, and the share of the window in which the device is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        eval_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(3):
            eval_step(batch)
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
    print(f'profiler window, 3 eval steps: wall {wall_ms:.2f} ms, '
          f'{sum(count for _, count, _ in rows)} kernels busy {busy_ms:.2f} ms '
          f'(device idle {100 * (1 - busy_ms / wall_ms):.1f} % of the window)')
    for ms, count, key in rows[:10]:
        print(f'  {ms:9.3f} ms  {count:5d} x  {key[:90]}')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this script runs on a GPU only')
    from glow_tts_tpu_torch import (Inferencer, TrainCollater,
                                    batch_to_device, initial_state_dict,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.ops import coupling, mas
    from glow_tts_tpu_torch.text import Tokenizer, text_filtering

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    start = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:      # one nvcc per source, together
        builds = [pool.submit(coupling.load_flow_step_library),
                  pool.submit(mas.load_mas_library)]
        for build in builds:
            build.result()
    print(f'flow-step and MAS kernels built and loaded in '
          f'{time.perf_counter() - start:.1f} s')

    config = load_config(CONFIG)
    inferencer = Inferencer(random_state_dict(config, SEED), config, device,
                            batch_size=2)
    worst = check_kernel(inferencer.model, device)
    mas_err = check_mas(device)
    serve_launches = serve(inferencer, config)
    compare_decode(inferencer, ['The birch canoe slid on the smooth planks.',
                                'Glue the sheet to the dark blue background.'],
                   256)
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
    eval_launches = run_eval(model, batches, config)
    compare_eval('from scratch', model, batches[0], config)
    # and with live couplings (a nonzero end conv), which a from-scratch
    # model does not have yet
    live = fresh_model(random_state_dict(config, SEED), config, device)
    live.data_dependent_init(batches[0]['mels'], batches[0]['mel_lengths'])
    compare_eval('live couplings', live, batches[1], config)

    flow_times = time_all(inferencer, prior_1024, device)
    mas_times, eval_step = time_eval(model, batches[0], config, device)
    profile_eval(eval_step, batches[0])

    print(json.dumps({'kernels': [
        {'name': 'flow_step', 'route': 'cuda',
         'source': 'glow_tts_tpu_torch/csrc/flow_step.cu',
         'replaces': 'glow_tts_tpu/ops/coupling.py:190',
         'launches': serve_launches + eval_launches[0],
         'launches_by_path': {'serve': serve_launches,
                              'eval': eval_launches[0]},
         'max_abs_err': worst, **flow_times, 'library_ms': None},
        {'name': 'mas', 'route': 'cuda',
         'source': 'glow_tts_tpu_torch/csrc/mas.cu',
         'replaces': 'glow_tts_tpu/ops/mas.py:147',
         'launches': eval_launches[1],
         'launches_by_path': {'serve': 0, 'eval': eval_launches[1]},
         'max_abs_err': mas_err, **mas_times, 'library_ms': None}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
