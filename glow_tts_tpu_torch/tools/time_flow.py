"""Time and check the bfloat16 flow step (#3, ``csrc/flow_step.cu``), flow
stack (#4, ``csrc/flow_stack.cu``) and affine coupling (#2,
``csrc/coupling.cu``) alone on one NVIDIA GPU, build by build: the measuring
script behind the redesign of their bfloat16 body that ``PERF.md``
compares.

    python3 -m glow_tts_tpu_torch.tools.time_flow [BUILD,...]
    python3 -m glow_tts_tpu_torch.tools.time_flow bars [DEPTH]

from the repository's root (it borrows ``chip_smoke.py``'s problems, checks
and timing from the working directory).  To compare two trees in one call,
run this file by its path from the root of each tree in turn, as
``tools/time_backward.py`` is run: for example ``cd parent && python3
../glow_tts_tpu_torch/tools/time_flow.py`` then the same from this tree, in
the order parent, change, change, parent; the working directory's package
and ``chip_smoke.py`` are the ones measured, this file only drives them.

The first form.  For each build asked for (``c160``: the shipped YAML;
``c160_pitch``: GR's; ``c80``: MiniSpeech's; ``c80_pitch``: GR at
Num_Squeeze 1; default all four; or a shape of ROADMAP B.2 where the
tree's ``chip_smoke.py`` names it in ``B2_SHAPES``: ``c200`` for 100-bin
mels, ``c200_pitch``, ``c16_ch16_l2_k5``, ``c160_ch128_l16_k3``, ``c256``
for 128-bin mels, ``c100`` and ``c100_pitch`` for 100-bin mels at
Num_Squeeze 1, ``c200_l8``), on a
model of that config with random
weights after its ActNorm init: #3, #4 and #2 bf16 in both directions, at
B = 32 x T = 512 with every frame valid and on the eval batch's ragged
lengths, each against its bf16 plain version (``chip_smoke.py``'s bar; #4
bit for bit against 12 launches of #3; where the tree's ``chip_smoke.py``
has it, #2 bit for bit against #3 on an identity ActNorm and mixing),
timed beside the f32 build on the same inputs and beside its plain
version, with its bounds (``chip_smoke.flow_kernel_rows``); then #3 and
#2 launched 20 at a time from a CUDA graph (their device time without the
host's share between launches) and, where the tree's ``flow_step`` and
``coupling`` have a timed instantiation (``ops/coupling.py::
flow_step_phases``, ``coupling_phases``), the cycles and microseconds a
computed tile spends in each phase, both directions, both shapes; first
the ``ptxas`` lines of the builds.

The second form.  Every bar of ``chip_smoke.py`` that the bfloat16 flow
step and stack feed (its bf16 phase and bf16 routes phase: the kernels
against their plain versions, #4 bit-equal to 12 x #3, the bf16 train
path's losses with the ActNorm init and two evals through #3, the routes'
eval losses and served mels, MiniSpeech at bf16), with the ring body built
at the summing depth DEPTH (16, 64 or 0 for a product's whole depth;
default the shipped one, ``csrc/flow_ring.cuh``): each bar's reading is
printed beside it, and a bar that fails ends the run with an error.
"""

import dataclasses
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

BUILDS = ('c160', 'c160_pitch', 'c80', 'c80_pitch')
SOURCES = ('flow_step.cu', 'flow_stack.cu', 'coupling.cu')


def problem(cs, build, device, root):
    """(model, eval_mask, pitch) of a build: a model of its config at f32
    with random weights after its ActNorm init on a batch of the config,
    the batch's squeezed mask, and whether the build takes a pitch
    operand."""
    from glow_tts_tpu_torch import load_config, random_state_dict
    from glow_tts_tpu_torch.models.decoder import squeeze
    from glow_tts_tpu_torch.models.layers import sequence_mask
    from glow_tts_tpu_torch.training.step import conditioning_inputs
    if build in getattr(cs, 'B2_SHAPES', {}):
        config = cs.b2_config(build, 'bfloat16')
        batch = cs.conditioned_batch(config, device, cs.SEED + 160)
    elif build == 'c160':
        config = load_config(cs.CONFIG)
        batch = cs.conditioned_batch(config, device, cs.SEED + 160)
    elif build == 'c80':
        config = cs.minispeech_config(root, 'bfloat16')
        batch = cs.minispeech_batch(config, device)
    else:
        config = (cs.mode_config('GR', dtype='bfloat16')
                  if build == 'c160_pitch'
                  else cs.gr_squeeze1_config('bfloat16'))
        batch = cs.conditioned_batch(config, device, cs.SEED + 162)
    f32 = dataclasses.replace(config, compute_dtype='float32')
    model = cs.fresh_model(random_state_dict(f32, cs.SEED + 163), f32,
                           device)
    model.data_dependent_init(batch['mels'], batch['mel_lengths'],
                              **conditioning_inputs(batch))
    _, eval_mask = squeeze(batch['mels'], sequence_mask(
        batch['mel_lengths'], batch['mels'].shape[1]),
        config.decoder.num_squeeze)
    return model, eval_mask, config.uses_gradient_reversal


def graph_ms(fn, launches=20, replays=10):
    """Device ms a call of ``fn`` takes: ``launches`` calls captured in one
    CUDA graph (no host work between the launches), replayed ``replays``
    times after a warm replay, timed by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (launches * replays)


@torch.no_grad()
def phases(cs, model, eval_mask, pitch, build, device):
    """#3 and #2 bf16 launched from a CUDA graph (device time alone, both
    directions and shapes), and the timed instantiations' cycles a tile,
    by phase, where the tree has them."""
    from glow_tts_tpu_torch.ops import coupling
    decoder = model.layer_Dict['Decoder']
    step = decoder.layer_Dict['Flows'][0]
    c = step.layers[0].logs.shape[1]
    # the timed instantiations are built at the shipped shapes (a tree
    # before other shapes built only those)
    timed = coupling.config_shape(model.config) in getattr(
        coupling, 'SHIPPED_SHAPES', [coupling.config_shape(model.config)]) \
        if hasattr(coupling, 'config_shape') else True
    gen = torch.Generator().manual_seed(cs.SEED + 141)
    t_all = max(512, eval_mask.shape[1])
    x, _ = cs.ragged_batch(gen, 32, t_all, c, device)
    cond, p = step.cond(32), None
    if pitch:
        # GR's rows and pitch operand, as flow_kernel_rows makes them
        config = model.config
        speakers = torch.randint(config.speaker_embedding.num_speakers,
                                 (32,), generator=gen).to(device)
        prosody = (torch.randn((32, config.prosody_encoder.size),
                               generator=gen) * 0.3).to(device)
        cond = decoder.conditioning(32, model.layer_Dict['LUT'](speakers),
                                    prosody, pitch=True)[0]
        p = torch.rand((32, t_all, config.decoder.num_squeeze),
                       generator=gen).to(device)
    x = x.to(torch.bfloat16)
    shapes = {'B=32 T=512': (x[:, :512].contiguous(),
                             torch.ones_like(x[:, :512, :1].float())),
              f'eval {tuple(eval_mask.shape[:2])}':
                  ((x[:, :eval_mask.shape[1]].float() * eval_mask).to(
                      torch.bfloat16).contiguous(), eval_mask)}
    c2 = c // 2

    def own(w, q):
        return {**cs.coupling_weights(w),
                **({'w_pitch': w['w_pitch']} if q is not None else {})}
    # (the wrapper's call, the timed instantiation or None) of each kernel
    kernels = {
        '#3': (lambda xs, m, w, r, q: coupling.flow_step(
                   xs, m, w, cond, r, pitch=q),
               (lambda xs, m, w, r, q: coupling.flow_step_phases(
                   xs, m, w, cond, r, q)) if timed else None),
        '#2': (lambda xs, m, w, r, q: coupling.coupling(
                   xs[..., :c2], xs[..., c2:], m, own(w, q), cond, pitch=q,
                   reverse=r),
               (lambda xs, m, w, r, q: coupling.coupling_phases(
                   xs[..., :c2], xs[..., c2:], m, own(w, q), cond, q, r))
               if timed and hasattr(coupling, 'coupling_phases') else None)}
    for shape, (xs, m) in shapes.items():
        q = None if p is None else p[:, :xs.shape[1]].contiguous()
        for reverse in (False, True):
            w = step.weights(reverse, torch.bfloat16)
            for kernel, (call, run) in kernels.items():
                ms = graph_ms(lambda: call(xs, m, w, reverse, q))
                print(f'{kernel} bf16 {build} {shape} reverse={reverse}: '
                      f'{ms:.4f} ms a launch from a CUDA graph')
                if run is None:
                    print(f'{kernel} bf16 {build}: no timed instantiation '
                          '(this tree has none, or not at this shape)')
                    continue
                run(xs, m, w, reverse, q)                   # warm-up
                _, _, got = run(xs, m, w, reverse, q)
                ghz = got['sm_ghz']
                total = sum(got['cycles'].values())
                print(f'{kernel} bf16 {build} {shape} reverse={reverse}: '
                      f'{got["tiles"]} tiles, {got["rounds"]} rounds, SM '
                      f'clock {ghz:.3f} GHz; a tile {total:.0f} cycles = '
                      f'{total / ghz / 1e3:.2f} us, x rounds '
                      f'{got["rounds"] * total / ghz / 1e6:.4f} ms:')
                for name, cycles in got['cycles'].items():
                    print(f'  {name:34s} {cycles:9.0f} cycles '
                          f'{cycles / ghz / 1e3:7.3f} us '
                          f'({100 * cycles / max(total, 1):5.1f} %)')


@torch.no_grad()
def run_builds(cs, builds, device):
    from glow_tts_tpu_torch.ops import coupling, cuda_build
    b2 = getattr(cs, 'B2_SHAPES', {})
    # (source, shape or flow width, pitch: its width or whether it has one)
    libs = [(source, *((coupling.FlowShape(*b2[name][0]), b2[name][1])
                       if name in b2 else
                       (80 if name.startswith('c80') else 160,
                        name.endswith('pitch'))))
            for name in builds for source in SOURCES]
    # the bf16 builds and the f32 builds they are timed beside, one nvcc
    # each, all together
    with ThreadPoolExecutor(2 * len(libs)) as pool:
        list(pool.map(lambda lib: coupling.load_flow_library(
            lib[0], lib[2], lib[1], lib[3]),
            [(*lib, bf16) for lib in libs for bf16 in (False, True)]))
    for source, channels, pitch in libs:
        for line in cuda_build.ptxas_report(
                source, coupling.build_defines(channels, pitch, True)):
            print(f'ptxas {line}')
    root = tempfile.mkdtemp(prefix='time_flow_')
    try:
        for build in builds:
            model, eval_mask, pitch = problem(cs, build, device, root)
            cs.flow_kernel_rows(model, device, eval_mask, f'bf16 {build}',
                                torch.bfloat16, pitch=pitch,
                                names=('flow_step', 'flow_stack', 'coupling'))
            phases(cs, model, eval_mask, pitch, build, device)
            del model
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_bars(cs, depth, device):
    """chip_smoke.py's bf16 phase and bf16 routes phase, the ring body at
    summing depth ``depth`` (None: the shipped)."""
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    load_config, random_state_dict)
    from glow_tts_tpu_torch.ops import coupling, coupling_grad
    from glow_tts_tpu_torch.text import Tokenizer
    coupling.RING_SUM_DEPTH = depth
    print(f'ring body summing depth: '
          f'{"shipped" if depth is None else depth or "whole"}')
    # every flow library the phases load, one nvcc each, all together
    loaders = (coupling.load_flow_step_library,
               coupling.load_coupling_library,
               coupling.load_flow_stack_library,
               coupling_grad.load_train_forward_library,
               coupling_grad.load_train_backward_library)
    with ThreadPoolExecutor(8 * len(loaders)) as pool:
        list(pool.map(lambda job: job[0](*job[1:]), [
            (load, pitch, channels, bf16) for load in loaders
            for bf16 in (False, True) for channels in (160, 80)
            for pitch in (False, True)]))
    config = dataclasses.replace(load_config(cs.CONFIG),
                                 compute_dtype='float32')
    collater = TrainCollater(config, Tokenizer())
    batches = [batch_to_device(collater(cs.synthetic_items(
        config, cs.SEED + k)), device) for k in (10, 11)]
    model = cs.fresh_model(random_state_dict(config, cs.SEED), config,
                           device)
    card = cs.card_line()
    cs.run_bf16_phase(model, batches, device, card)
    cs.run_bf16_routes_phase(batches, device, card)
    print('every bar held')


def main(argv):
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit('time_flow: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    print(cs.card_line())
    print(f'tree {os.getcwd()}')
    if argv and argv[0] == 'bars':
        return run_bars(cs, int(argv[1]) if len(argv) > 1 else None, device)
    builds = argv[0].split(',') if argv else BUILDS
    unknown = set(builds) - set(BUILDS) - set(getattr(cs, 'B2_SHAPES', {}))
    if unknown:
        sys.exit(f'time_flow: unknown builds {sorted(unknown)}')
    run_builds(cs, builds, device)


if __name__ == '__main__':
    main(sys.argv[1:])
