"""How far the bf16 train stack (#5 and #6 at bfloat16) and its bf16 plain
version each sit from the f32 plain version, seed by seed, on one NVIDIA
GPU: the measurement behind ``PERF.md``'s reading of the card tests' bf16
bar at deep WaveNets.

    python3 -m glow_tts_tpu_torch.tools.bf16_spread [C,CH,LAYERS,K ...]

from the repository's root (it borrows ``tests/test_torch_cuda.py``'s
``_b2_train`` problem: a ragged batch of 2 flow steps with cond, dropout 0
and 0.05, seeds 700–704).  For each shape (default: C = 200 at 8 and at 4
layers of the shipped WaveNet, and the 16-layer k3 WaveNet 128 wide) and
each seed it prints, for z and the logdet, max|kernel − plain_bf16|
beside the card tests' bar 2·max|plain_bf16 − plain_f32| + 1e-6 (and
their ratio), max|kernel − plain_f32| and max|plain_bf16 − plain_f32|;
then each shape's mean of the last two over its runs.
"""

import importlib.util
import os
import sys

import torch

SHAPES = ((200, 192, 8, 5), (200, 192, 4, 5), (160, 128, 16, 3))
SEEDS = (700, 701, 702, 703, 704)


def main(argv):
    if not torch.cuda.is_available():
        sys.exit('bf16_spread: no CUDA device')
    path = os.path.join(os.getcwd(), 'tests', 'test_torch_cuda.py')
    spec = importlib.util.spec_from_file_location('card_tests', path)
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    device = torch.device('cuda', 0)
    shapes = ([tuple(int(v) for v in a.split(',')) for a in argv]
              or SHAPES)
    for shape in shapes:
        far = {'kernel': [], 'plain_bf16': []}
        for rate in (0.0, 0.05):
            for seed in SEEDS:
                kernel, p16, p32 = card._b2_train(device, shape, 0,
                                                  torch.bfloat16, rate=rate,
                                                  seed=seed)
                parts = []
                for key in ('z', 'ld'):
                    to_plain = (kernel[key] - p16[key]).abs().max().item()
                    own = (p16[key] - p32[key]).abs().max().item()
                    to_f32 = (kernel[key] - p32[key]).abs().max().item()
                    bar = 2 * own + 1e-6
                    parts.append(f'{key}: kernel-plain_bf16 {to_plain:.4f} '
                                 f'bar {bar:.4f} (ratio {to_plain / bar:.2f})'
                                 f' kernel-f32 {to_f32:.4f} plain_bf16-f32 '
                                 f'{own:.4f}')
                    if key == 'ld':
                        far['kernel'].append(to_f32)
                        far['plain_bf16'].append(own)
                print(shape, rate, seed, ' | '.join(parts), flush=True)
        print(f'{shape}: logdet from f32 on average, kernel '
              f'{sum(far["kernel"]) / len(far["kernel"]):.4f}, bf16 plain '
              f'{sum(far["plain_bf16"]) / len(far["plain_bf16"]):.4f}')


if __name__ == '__main__':
    main(sys.argv[1:])
