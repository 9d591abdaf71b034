"""Time and check the train-direction flow kernels alone on one NVIDIA GPU:
the measuring script behind the variants of ``csrc/flow_train_bwd.cu`` and
``csrc/flow_train_fwd.cu`` that ``PERF.md`` compares.

    python3 -m glow_tts_tpu_torch.tools.time_backward [passes,...] [BUILD]
    python3 -m glow_tts_tpu_torch.tools.time_backward bf16 [BUILD,...]

from the repository's root (it borrows ``chip_smoke.py``'s problems and
timing helpers from the working directory).  To compare two trees in one
call, run this file by its path from the root of each tree in turn, for
example ``cd parent && python3 ../glow_tts_tpu_torch/tools/time_backward.py
bf16`` then the same from this tree, in the order parent, change, change,
parent: the working directory's package and ``chip_smoke.py`` are the ones
measured, this file only drives them.

f32 (the first form).  At the training shape (B = 32, 512 squeezed frames,
the synthetic batch's ragged lengths, dropout 0.05) of the shipped width,
or of the build ``BUILD`` names (one of ``BUILDS``: ``c160``, the default,
or a B.2 build), it prints, for each number of TF32 passes asked for
(default ``3,1``; a B.2 build's 3 alone, one pass being built at the
shipped shapes): the worst gradient error against autograd of the plain
version and the backward's time per flow step; and at the shipped width
the two GEMMs alone (the k-tap conv's activation and weight gradient, and
the 1×1 res/skip conv's) with every frame valid and with the batch's
lengths, beside their error against an f64 product.

bf16 (the second form).  For each build asked for (``c160``: the shipped
YAML's train problem; ``c160_pitch``: GR's; ``c80``: MiniSpeech's;
``c80_pitch``: GR at Num_Squeeze 1; default those four; or the B.2
builds of ``chip_smoke.py::B2_SHAPES``, ROADMAP B.2: ``c200``, 100-bin
mels, ``c200_pitch``, GR's, ``c16_ch16_l2_k5``, ``c160_ch128_l16_k3``,
``c256``, 128-bin mels, ``c100`` and ``c100_pitch``, 100-bin mels at
Num_Squeeze 1, ``c200_l8``, 100-bin mels at 8 layers, each on
``chip_smoke.py::b2_train_problem``'s operands) on the stack's
operands as a train step hands them over, rounded to bfloat16: #5's
storing forward and #6's backward per flow step (CUDA events, mean of two
runs), the gradients' norm-relative error against the bf16 plain version
and a bit-equality check of two runs; and, for the first build, a
``torch.profiler`` window over the backward that splits #6 by its launches
in their order (``launch_plan``), each beside its own bound, and the
``ptxas`` lines of both sources; and last, when ``c160`` is among them,
the shipped YAML's train step at bf16 and at f32 on one batch by CUDA
events and by device work (``chip_smoke.time_bf16_step``).
"""

import dataclasses
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

BF16_BUILDS = ('c160', 'c160_pitch', 'c80', 'c80_pitch')
# the B.2 builds (chip_smoke.py::B2_SHAPES' labels), taken by both forms
B2_BUILDS = ('c200', 'c200_pitch', 'c16_ch16_l2_k5', 'c160_ch128_l16_k3',
             'c256', 'c100', 'c100_pitch', 'c200_l8')
BUILDS = BF16_BUILDS + B2_BUILDS
# the nine kernels of csrc/flow_train_bwd.cu, as the profiler names them
# (demangled, in the source's anonymous namespace)
BWD_KERNELS = ('gemm_nt', 'gemm_nt_tail', 'gemm_tn', 'gemm_pair',
               'gemm_pair_tail', 'column_sums', 'pitch_backward',
               'reduce_partials', 'affine_backward')
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12


def launch_plan(b, t, c, ch, n, k, lengths, pitch_width=0, chunks=None):
    """#6's launches of one flow step in their order, each as (label,
    bytes, operations) of the function it computes at bf16: every GEMM
    operand read once in bfloat16, the f32 outputs (partials, cotangents)
    written once, the operations of the valid frames alone (``lengths``,
    the samples' lengths); ``chunks(taps, kseg, width)`` the weight
    gradients' chunk counts (their partials), one if None."""
    chunks = chunks or (lambda taps, kseg, width: 1)
    m, mv, c2, ch2 = b * t, int(sum(lengths)), c // 2, 2 * ch

    def dgrad(rows, n_out, depth, taps=1, epilogue_bytes=0):
        # A [rows, depth] and W [taps, n_out, depth] in, [rows, n_out] out
        return (2 * (rows * depth + taps * n_out * depth)
                + 4 * rows * n_out + epilogue_bytes,
                2 * rows * n_out * depth * taps)

    def wgrad(kseg, width, taps=1):
        return (2 * mv * (kseg + width) + 4 * chunks(taps, kseg, width)
                * taps * kseg * width, 2 * mv * kseg * width * taps)

    def pair(name, d, w):
        return (name, d[0] + w[0], d[1] + w[1])

    plan = [('affine_backward', m * c2 * (4 + 2 + 2 + 4 * 2 + 4 + 2 * 3)
             + 4 * m, 0),
            pair('end conv pair', dgrad(mv, ch, c), wgrad(ch, c))]
    for i in range(n - 1, -1, -1):
        # the gate's backward reads ts and writes dpre, dacc, the gate and
        # dpre's bf16 copy
        plan.append((f'layer {i} res/skip dgrad',
                     *dgrad(mv, ch, ch2, epilogue_bytes=mv * (
                         2 * ch2 + 4 * 2 * ch2 + 2 * ch + 2 * ch2))))
        sums = 3 if i == n - 1 else 2
        plan.append((f'layer {i} column sums', 4 * mv * ch2 * sums, 0))
        if pitch_width:
            plan.append((f'layer {i} pitch backward',
                         4 * mv * (ch2 + pitch_width), 4 * mv * ch2
                         * pitch_width))
        plan.append((f'layer {i} res/skip wgrad', *wgrad(ch, ch2)))
        plan.append(pair(f'layer {i} k-tap pair',
                         dgrad(mv, ch, ch2, taps=k), wgrad(ch, ch2, taps=k)))
    plan.append(pair('start conv pair', dgrad(mv, c2, ch), wgrad(c2, ch)))
    plan.append(pair('mixing pair', dgrad(mv, c, c), wgrad(c, c)))
    plan.append(('column sums', 4 * mv * (ch + 2 * c), 0))
    weights = (c * c + c2 * ch + n * (k + 1) * ch * ch2 + ch * c)
    plan.append(('reduce_partials', 4 * (2 * weights + b * (2 * c + ch
                                                            + 2 * n * ch2)),
                 0))
    return plan


def bound_ms(moved, flops):
    return max(moved / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S) * 1e3


def build_shape(cs, build):
    """(FlowShape, the pitch operand's width) of a build's name."""
    from glow_tts_tpu_torch.ops.coupling import FlowShape
    if build in B2_BUILDS:
        shape, ps = cs.B2_SHAPES[build]
        return FlowShape(*shape), ps
    return (FlowShape(80 if build.startswith('c80') else 160),
            (1 if build.startswith('c80') else 2) if build.endswith('pitch')
            else 0)


def bf16_problem(cs, build, device):
    """(x, mask, weights, cond, pitch) of a build's train problem at full
    width, as ``chip_smoke.py``'s bf16 and B.2 phases make them (f32
    operands; the caller rounds x)."""
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.text import Tokenizer
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    if build in B2_BUILDS:
        config = cs.b2_config(build)
        batch = (cs.conditioned_batch(config, device, cs.SEED + 261)
                 if config.uses_gradient_reversal else
                 batch_to_device(TrainCollater(config, Tokenizer())(
                     cs.synthetic_items(config, cs.SEED + 262)), device))
        return cs.b2_train_problem(build, config,
                                   cs.random_state_dict_of(config), batch,
                                   device)
    if build == 'c160':
        config = dataclasses.replace(load_config(cs.CONFIG),
                                     compute_dtype='float32')
        batch = batch_to_device(TrainCollater(config, Tokenizer())(
            cs.synthetic_items(config, cs.SEED + 10)), device)
        state = random_state_dict(config, cs.SEED)
    elif build == 'c80':
        config = cs.minispeech_config(tempfile.mkdtemp(prefix='tb_'),
                                      'float32')
        batch = cs.minispeech_batch(config, device)
        state = random_state_dict(config, cs.SEED + 95)
    else:
        config = (cs.mode_config('GR') if build == 'c160_pitch'
                  else cs.gr_squeeze1_config())
        batch = cs.conditioned_batch(config, device, cs.SEED + 80)
        state = random_state_dict(config, cs.SEED + 81)
    model = cs.train_model(state, config, device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              **conditioning_inputs(batch))
    if build.endswith('pitch'):
        return cs.pitch_stack_problem(model, batch, config)
    return (*cs.stack_problem(model, batch, config), None, None)


def breakdown(cs, fn, plan, steps, repeats=2):
    """#6's kernels in a profiler window over ``repeats`` calls of ``fn``
    (a backward of ``steps`` flow steps), in launch order, averaged by
    their place in a step's launches; printed beside ``plan``'s bounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = sorted(
        (event.time_range.start, event.time_range.elapsed_us() / 1e3,
         event.name) for event in prof.events()
        if event.device_type == DeviceType.CUDA
        and any(f'::{name}<' in event.name or f'::{name}(' in event.name
                for name in BWD_KERNELS))
    per_step = len(plan)
    if not events or len(events) != repeats * steps * per_step:
        print(f'breakdown: {len(events)} kernel events, expected '
              f'{repeats * steps * per_step}: not split')
        return
    total = 0.0
    print(f'#6 bf16 by launch (mean over {repeats * steps} flow steps; '
          'bound = bytes at 3.35 TB/s or operations at 989 TFLOP/s):')
    for j, (label, moved, flops) in enumerate(plan):
        ms = [events[i][1] for i in range(j, len(events), per_step)]
        mean = sum(ms) / len(ms)
        total += mean
        kernel = events[j][2].split('(anonymous namespace)::')[-1][:40]
        print(f'  {j:2d} {label:28s} {mean:.4f} ms  bound '
              f'{bound_ms(moved, flops):.4f} ms  ({kernel})')
    print(f'  sum of the launches {total:.4f} ms per flow step')


def run_bf16(cs, builds, device):
    from glow_tts_tpu_torch.ops import coupling_grad as cg
    from glow_tts_tpu_torch.ops import cuda_build
    from glow_tts_tpu_torch.ops.coupling import build_defines
    bf16 = torch.bfloat16
    libs = [(source, build_defines(*build_shape(cs, name), True))
            for name in builds
            for source in ('flow_train_fwd.cu', 'flow_train_bwd.cu')]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: cuda_build.load_library(*lib), libs))
    for source, defines in libs[:2]:
        for line in cuda_build.ptxas_report(source, defines):
            print(line)
    for j, build in enumerate(builds):
        x, mask, weights, cond, pitch = bf16_problem(cs, build, device)
        x16 = x.to(bf16)
        steps = weights['w_in'].shape[0]
        gen = torch.Generator().manual_seed(cs.SEED + 105)
        dz = torch.randn(x.shape, generator=gen).to(device)
        dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(device)
        leaves = {key: value.clone().requires_grad_()
                  for key, value in weights.items()}
        xl = x16.detach().clone().requires_grad_()
        store = cs.forced_route('store')

        def forward(fn=store):
            return fn(xl, mask, leaves, cond, pitch, seed=cs.SEED,
                      dropout_rate=cs.FLOW_RATE)

        def grads(fn):
            z, ld = forward(fn)
            return torch.autograd.grad((z.float(), ld),
                                       [xl, *leaves.values()], (dz, dld))

        got, again = grads(store), grads(store)
        plain = grads(cg.flow_stack_train_reference)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = max(cs.norm_rel(a, p) for a, p in zip(got, plain)
                    if p.norm() > 0)
        z, ld = forward()
        fwd = [cs.cuda_ms(forward, 3, 1) / steps for _ in range(2)]
        bwd = [cs.cuda_ms(lambda: torch.autograd.grad(
            (z.float(), ld), [xl, *leaves.values()], (dz, dld),
            retain_graph=True), 3, 1) / steps for _ in range(2)]
        print(f'bf16 {build} {tuple(x.shape)}, {steps} steps: #5 storing '
              f'{sum(fwd) / 2:.4f} ms per flow step (runs '
              f'{fwd[0]:.4f}, {fwd[1]:.4f}), #6 {sum(bwd) / 2:.4f} ms per '
              f'flow step (runs {bwd[0]:.4f}, {bwd[1]:.4f}); gradients '
              f'norm-rel vs bf16 plain {worst:.3e}; two runs bit-equal '
              f'{equal}')
        if j == 0:
            b, t, c = x.shape
            _, n, k, ch, _ = weights['w_in'].shape
            lengths = cg._valid_lengths(mask).tolist()
            lib = cg.load_train_backward_library(
                *build_shape(cs, build)[::-1], True)
            plan = launch_plan(b, t, c, ch, n, k, lengths,
                               0 if pitch is None else pitch.shape[-1],
                               lambda *a: lib.glow_flow_train_bwd_chunks(
                                   b, *a))
            breakdown(cs, lambda: torch.autograd.grad(
                (z.float(), ld), [xl, *leaves.values()], (dz, dld),
                retain_graph=True), plan, steps)
        del z, ld, got, again, plain
    if 'c160' in builds:
        from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                        load_config)
        from glow_tts_tpu_torch.text import Tokenizer
        config = load_config(cs.CONFIG)
        batch = batch_to_device(TrainCollater(config, Tokenizer())(
            cs.synthetic_items(config, cs.SEED + 10)), device)
        cs.time_bf16_step(config, batch, device)


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit('time_backward: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    print(cs.card_line())
    print(f'tree {os.getcwd()}')
    if argv and argv[0] == 'bf16':
        builds = argv[1].split(',') if len(argv) > 1 else BF16_BUILDS
        unknown = set(builds) - set(BUILDS)
        if unknown:
            sys.exit(f'time_backward: unknown builds {sorted(unknown)}')
        return run_bf16(cs, builds, device)
    build = argv[1] if len(argv) > 1 else 'c160'
    if build not in ('c160',) + B2_BUILDS:
        sys.exit(f'time_backward: the f32 form takes c160 or a B.2 build '
                 f'{B2_BUILDS}, got {build}')
    run_f32(cs, argv[:1], device, build)


def run_f32(cs, argv, device, build='c160'):
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.ops import coupling_grad as cg
    from glow_tts_tpu_torch.ops import cuda_build
    from glow_tts_tpu_torch.ops.coupling import build_defines
    from glow_tts_tpu_torch.text import Tokenizer
    variants = [int(v) for v in (argv[0] if argv else
                                 '3,1' if build == 'c160' else '3').split(',')]
    shape, ps = build_shape(cs, build)
    cg.load_train_forward_library(ps, shape)
    cg.load_train_backward_library(ps, shape)
    for line in cuda_build.ptxas_report('flow_train_bwd.cu',
                                        build_defines(shape, ps)):
        if 'gemm' in line:
            print(line)

    cond = pitch = None
    if build in B2_BUILDS:
        x, mask, weights, cond, pitch = bf16_problem(cs, build, device)
    else:
        config = load_config(cs.CONFIG)
        batch = batch_to_device(
            TrainCollater(config, Tokenizer())(
                cs.synthetic_items(config, cs.SEED + 10)), device)
        model = cs.train_model(random_state_dict(config, cs.SEED), config,
                               device)
        model.data_dependent_init(batch['mels'], batch['mel_lengths'])
        x, mask, weights = cs.stack_problem(model, batch, config)
        del model
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    dz = torch.randn(x.shape, generator=gen).to(device)
    dld = (0.5 + torch.rand(x.shape[0], generator=gen)).to(device)
    steps = weights['w_in'].shape[0]

    def leaves():
        return (x.clone().requires_grad_(),
                {key: value.clone().requires_grad_()
                 for key, value in weights.items()})

    def gradients(fn):
        xl, wl = leaves()
        z, ld = fn(xl, mask, wl, cond, pitch, seed=cs.SEED + 6,
                   dropout_rate=cs.FLOW_RATE)
        (torch.sum(z * dz) + torch.sum(ld * dld)).backward()
        torch.cuda.synchronize()
        return {'x': xl.grad, **{key: leaf.grad for key, leaf in wl.items()}}

    def backward_ms(fn):
        xl, wl = leaves()
        z, ld = fn(xl, mask, wl, cond, pitch, seed=cs.SEED,
                   dropout_rate=cs.FLOW_RATE)
        return cs.cuda_ms(lambda: torch.autograd.grad(
            (z, ld), [xl, *wl.values()], (dz, dld), retain_graph=True),
            5, 1) / steps

    ref = gradients(cg.flow_stack_train_reference)
    for passes in variants:
        got = gradients(cs.forced_route('store', passes))
        errs = {key: cs.rel_err(got[key], value)
                for key, value in ref.items() if key != 'ld_const'}
        print(f'passes={passes}: worst gradient rel err '
              f'{max(errs.values()):.3e} '
              + ', '.join(f'd{key} {err:.1e}' for key, err in errs.items()))
    runs = [(route, passes, backward_ms(cs.forced_route(route, passes)))
            for route in ('store', 'recompute')
            for passes in variants + variants[::-1]]
    for route in ('store', 'recompute'):
        for passes in variants:
            ms = [t for r, p, t in runs if (r, p) == (route, passes)]
            print(f'{build} backward per flow step, route {route!r}, '
                  f'passes={passes}: {sum(ms) / len(ms):.4f} ms')
    if build != 'c160':
        return

    b, t, ch, k = 32, 512, 192, 5
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    dpre = torch.randn((b, t, 2 * ch), generator=gen).to(device)
    xin = torch.randn((b, t, ch), generator=gen).to(device)
    w_in = (torch.randn((k, ch, 2 * ch), generator=gen) * .03).to(device)
    w_rs = (torch.randn((1, ch, 2 * ch), generator=gen) * .03).to(device)
    pad = (k - 1) // 2
    for name, m in (('all frames valid', torch.ones_like(mask)),
                    ('the batch\'s lengths', mask)):
        dm, xm = dpre * m, xin * m
        padded = torch.nn.functional.pad(dm, (0, 0, pad, pad)).double()
        exact = sum(padded[:, 2 * pad - tap: 2 * pad - tap + t]
                    @ w_in[tap].double().T for tap in range(k)) * m
        for passes in variants:
            times = [cs.cuda_ms(fn, 20) for fn in (
                lambda: cg._dgrad_product(dm, w_in, m, passes),
                lambda: cg._wgrad_product(xm, dm, m, k, passes),
                lambda: cg._dgrad_product(dm, w_rs, m, passes),
                lambda: cg._wgrad_product(xm, dm, m, 1, passes))]
            err = cs.rel_err(cg._dgrad_product(dm, w_in, m, passes).double(),
                             exact)
            print(f'{name}, passes={passes}: k-tap dgrad {times[0]:.4f} ms '
                  f'(rel err vs f64 {err:.2e}), k-tap wgrad + reduction '
                  f'{times[1]:.4f} ms, 1x1 dgrad (K=384, N=192) '
                  f'{times[2]:.4f} ms, 1x1 wgrad (K=192, N=384) '
                  f'{times[3]:.4f} ms')


if __name__ == '__main__':
    main(sys.argv[1:])
