"""Compare the ``ptxas`` report of the flow sources' builds (registers,
barriers, shared memory, stack and spills, kernel by kernel) in this
checkout with another checkout's, both built with the same flags side by
side, each into its own ``glow_tts_tpu_torch/_build``.

    python -m glow_tts_tpu_torch.tools.compare_ptxas [--bf16] [--sass]
        [--shape SHAPE] [--compare-shape SHAPE] [--source NAME]
        OTHER_CHECKOUT

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
compared too.  A build is SAME when its kernels' resource lines (registers,
barriers, shared memory, stack, spills) are the other's, as a set of lines
(a kernel's name may carry its shape's template arguments, which a change
to the shape's template moves); with ``--sass``
also when every kernel's machine code (``cuobjdump -sass``, the function's
name dropped) is the other's.  ``--shape`` prints (does not compare: the
other checkout may not build it) each flow source's f32 and bf16 build at
another decoder shape (``ops/coupling.py::build_defines``, ROADMAP B.2),
the train pair's (#5, #6) among them; ``--compare-shape`` compares them
with the other checkout's, as the shipped builds (for a B.2 build both
trees take).  A SHAPE is ``C,CH,LAYERS,K[,PITCH]`` or a label of
``chip_smoke.py::B2_SHAPES`` (``c200``, ``c256``, ``c100_pitch``, ...).
``--source`` (repeatable) limits the run to those sources, for example the
train pair's two.  Exits 1 if a compared build differs or fails.  Needs
``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
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
# the sources built at other decoder shapes (--shape): every flow source
SHAPED = SOURCES[1:]


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


# run in a checkout's root, so that its own package is the one imported:
# the ptxas lines, then the library's path
REPORT = ('import sys; from glow_tts_tpu_torch.ops import cuda_build as c; '
          'd = tuple(sys.argv[2:]); c.load_library(sys.argv[1], d); '
          'print("\\n".join(c.ptxas_report(sys.argv[1], d))); '
          'print(c.library_path(sys.argv[1], d))')


def report(root: str, source: str, defines: tuple) -> tuple:
    """``cuda_build.ptxas_report`` of ``source`` built with ``defines`` in
    the checkout ``root``, each line without its label, and the library's
    path."""
    out = subprocess.run([sys.executable, '-c', REPORT, source, *defines],
                         cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f'{root}: {source} {defines}: '
                           f'{out.stderr[-3000:]}')
    *lines, path = out.stdout.strip().splitlines()
    return sorted(line.split(' ', 1 + len(defines))[-1]
                  for line in lines), path


def resources(lines: list) -> list:
    """The resource part of each ptxas line (after the kernel's name)."""
    return [line.split(': ', 1)[-1] for line in lines]


def sass(path: str) -> list:
    """A digest of each kernel's machine code in the library at ``path``
    (``cuobjdump -sass``, the lines naming the function dropped), sorted:
    two builds whose kernels differ only in their names give the same
    list."""
    from glow_tts_tpu_torch.ops.cuda_build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', path], check=True,
                          capture_output=True, text=True).stdout
    bodies = re.split(r'\n\s*Function : \S+\n', text)[1:]
    return sorted(hashlib.sha256(
        '\n'.join(line for line in body.splitlines()
                  if '.text.' not in line and 'Function' not in line)
        .encode()).hexdigest() for body in bodies)


def shape_builds(spec: str) -> list:
    """The f32 and bf16 builds' macros of the decoder shape ``spec``
    (``C,CH,LAYERS,K[,PITCH]``, or a label of ``chip_smoke.py::B2_SHAPES``
    in this checkout)."""
    from glow_tts_tpu_torch.ops.coupling import FlowShape, build_defines
    if ',' in spec:
        c, ch, n, k, *ps = (int(v) for v in spec.split(','))
        shape, pitch = (c, ch, n, k), ps[0] if ps else 0
    else:
        import chip_smoke
        shape, pitch = chip_smoke.B2_SHAPES[spec]
    return [build_defines(FlowShape(*shape), pitch, bf16)
            for bf16 in (False, True)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('other', help='the other checkout\'s root')
    parser.add_argument('--bf16', action='store_true',
                        help='compare the redesigned bfloat16 builds too')
    parser.add_argument('--sass', action='store_true',
                        help='compare each kernel\'s machine code too')
    parser.add_argument('--shape', action='append', default=[],
                        help='C,CH,LAYERS,K[,PITCH] or a B.2 label: print '
                        'the flow sources\' builds at this decoder shape')
    parser.add_argument('--compare-shape', action='append', default=[],
                        help='as --shape, compared with the other '
                        'checkout\'s builds')
    parser.add_argument('--source', action='append', choices=SOURCES,
                        help='only this source (repeatable; default all)')
    args = parser.parse_args(argv)
    sources = tuple(args.source or SOURCES)
    other = os.path.abspath(args.other)
    sys.path.insert(0, HERE)
    shaped = [d for spec in args.shape for d in shape_builds(spec)]
    held = tuple(d for spec in args.compare_shape
                 for d in shape_builds(spec))

    def builds(source):
        return compared(source, args.bf16) + (held if source in SHAPED
                                              else ())
    jobs = [(root, source, defines) for source in sources
            for root, defines in [(r, d) for d in builds(source)
                                  for r in (other, HERE)]
            + [(HERE, d) for d in own(source, args.bf16)]
            + [(HERE, d) for d in (shaped if source in SHAPED else ())]]
    # one nvcc a core: some 80 builds at once would hold more memory than
    # the machine has
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        results = dict(zip(jobs, pool.map(lambda job: report(*job), jobs)))
    same = True
    for source in sources:
        for defines in builds(source):
            theirs, their_lib = results[(other, source, defines)]
            ours, our_lib = results[(HERE, source, defines)]
            label = ' '.join([source, *(f'-D{d}' for d in defines)])
            equal = sorted(resources(theirs)) == sorted(resources(ours))
            line = (f'{label}: ptxas {"SAME" if equal else "DIFFERENT"} '
                    f'({len(theirs)} kernels there, {len(ours)} here)')
            if args.sass:
                code = sass(their_lib) == sass(our_lib)
                line += f'; machine code {"SAME" if code else "DIFFERENT"}'
                equal &= code
            same &= equal
            print(line)
            if not equal:
                for line in theirs:
                    print(f'  there {line}')
                for line in ours:
                    print(f'  here  {line}')
        for defines in (*own(source, args.bf16),
                        *(shaped if source in SHAPED else ())):
            label = ' '.join([source, *(f'-D{d}' for d in defines)])
            for line in results[(HERE, source, defines)][0]:
                print(f'  {label} {line}')
    print(f'compared builds identical: {same}')
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
