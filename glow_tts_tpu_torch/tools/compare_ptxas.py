"""Compare the ``ptxas`` report of the flow sources' builds (registers,
barriers, shared memory, stack and spills, kernel by kernel) in this
checkout with another checkout's, both built with the same flags side by
side, each into its own ``glow_tts_tpu_torch/_build``.

    python -m glow_tts_tpu_torch.tools.compare_ptxas [--bf16] OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a directory holding another tree's
``glow_tts_tpu_torch`` package (for example ``git archive`` of the
commit before a change, unpacked).  For each kernel source, every build
the port makes of it is compared and reported SAME or DIFFERENT (with
both sides' lines where they differ): MAS's one build, and each flow
source's shipped build, its pitch build (``-DGLOW_PITCH``), its
80-channel build (``-DGLOW_CHANNELS=80``), the two together, and the
bfloat16 builds (``-DGLOW_BF16``) of the four; except the bfloat16
builds of the sources in ``REDESIGNED_BF16``, which have bfloat16 designs
of their own (#2, #3, #4, #5 and #6) and are printed; with ``--bf16``
(another checkout whose bfloat16 designs are this one's) those are
compared too.  Exits 1 if a compared build differs or fails.  Needs
``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = ('mas.cu', 'flow_step.cu', 'coupling.cu', 'flow_stack.cu',
           'flow_train_fwd.cu', 'flow_train_bwd.cu')
# the flow sources' builds, the macros in ops/coupling.py::build_defines'
# order
F32_BUILDS = ((), ('GLOW_PITCH',), ('GLOW_CHANNELS=80',),
              ('GLOW_PITCH', 'GLOW_CHANNELS=80'))
BF16_BUILDS = tuple(d + ('GLOW_BF16',) for d in F32_BUILDS)
# the sources whose bfloat16 builds have designs of their own in this
# tree: printed, not compared (#3, #4 and #2 run flow_ring.cuh's body)
REDESIGNED_BF16 = ('flow_step.cu', 'flow_stack.cu', 'coupling.cu',
                   'flow_train_fwd.cu', 'flow_train_bwd.cu')


def compared(source: str, bf16: bool = False) -> tuple:
    """The builds of ``source`` held against the other checkout's (with
    ``bf16``, every bfloat16 build too)."""
    if source == 'mas.cu':
        return ((),)
    return F32_BUILDS + (() if source in REDESIGNED_BF16 and not bf16
                         else BF16_BUILDS)


def own(source: str, bf16: bool = False) -> tuple:
    """The builds of ``source`` printed from this checkout alone."""
    return BF16_BUILDS if source in REDESIGNED_BF16 and not bf16 else ()


# run in a checkout's root, so that its own package is the one imported
REPORT = ('import sys; from glow_tts_tpu_torch.ops import cuda_build as c; '
          'd = tuple(sys.argv[2:]); c.load_library(sys.argv[1], d); '
          'print("\\n".join(c.ptxas_report(sys.argv[1], d)))')


def report(root: str, source: str, defines: tuple) -> list:
    """``cuda_build.ptxas_report`` of ``source`` built with ``defines`` in
    the checkout ``root``, each line without its label."""
    out = subprocess.run([sys.executable, '-c', REPORT, source, *defines],
                         cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f'{root}: {source} {defines}: '
                           f'{out.stderr[-3000:]}')
    return sorted(line.split(' ', 1 + len(defines))[-1]
                  for line in out.stdout.strip().splitlines())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('other', help='the other checkout\'s root')
    parser.add_argument('--bf16', action='store_true',
                        help='compare the redesigned bfloat16 builds too')
    args = parser.parse_args(argv)
    other = os.path.abspath(args.other)
    jobs = [(root, source, defines) for source in SOURCES
            for root, defines in [(r, d) for d in compared(source, args.bf16)
                                  for r in (other, HERE)]
            + [(HERE, d) for d in own(source, args.bf16)]]
    # one nvcc a core: some 80 builds at once would hold more memory than
    # the machine has
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        results = dict(zip(jobs, pool.map(lambda job: report(*job), jobs)))
    same = True
    for source in SOURCES:
        for defines in compared(source, args.bf16):
            theirs = results[(other, source, defines)]
            ours = results[(HERE, source, defines)]
            label = ' '.join([source, *(f'-D{d}' for d in defines)])
            equal = theirs == ours
            same &= equal
            print(f'{label}: {"SAME" if equal else "DIFFERENT"} '
                  f'({len(theirs)} kernels there, {len(ours)} here)')
            if not equal:
                for line in theirs:
                    print(f'  there {line}')
                for line in ours:
                    print(f'  here  {line}')
        for defines in own(source, args.bf16):
            label = ' '.join([source, *(f'-D{d}' for d in defines)])
            for line in results[(HERE, source, defines)]:
                print(f'  {label} {line}')
    print(f'compared builds identical: {same}')
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
