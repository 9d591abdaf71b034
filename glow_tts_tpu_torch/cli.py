"""Console entry points of the port (``pyproject.toml``:
``glow-tts-torch-train``, ``glow-tts-torch-infer``, and
``glow-tts-torch-patterns``, the ETL of ``data/pattern_generator.py``),
with the flags of ``glow_tts_tpu/cli.py`` and ``--device`` (default
``cuda``; it raises where CUDA is absent).

    glow-tts-torch-patterns -hp configs/MiniSpeech.yaml -lj corpus -text
    glow-tts-torch-train -hp configs/Hyper_Parameters.yaml [-s STEP]
        [--profile START:STOP]
    torchrun --nproc_per_node N -m glow_tts_tpu_torch.cli -hp ... [-s STEP]
    glow-tts-torch-infer -c results/Checkpoint [-s STEP] -f lines.tsv -o out
        [-wav]

Training and serving run on ``TPU.data_parallel × TPU.model_parallel``
processes, one per card: data-parallel over the first (0, the shipped
value: every visible card the model groups leave; ``parallel/data.py``),
the model sharded over groups of the second (``parallel/tp.py``).  Under
``torchrun`` each process is one rank on ``cuda:LOCAL_RANK``; with no
launcher, ``glow-tts-torch-train`` and ``glow-tts-torch-infer`` start the
processes themselves on this host when there is more than one (the
serving config is the checkpoint's snapshot: its ``TPU`` section says how
many).  ``glow-tts-torch-infer`` splits each global batch over the data
groups (``inference.py``) and prints and writes once, from rank 0.
``--profile a:b`` traces steps ``a`` to ``b`` with ``torch.profiler`` into
a Chrome trace per rank under ``<Log_Path>/profile``.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
from typing import Optional, Sequence


def train_main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog='glow-tts-torch-train')
    parser.add_argument('-hp', '--hyper_parameters',
                        default='configs/Hyper_Parameters.yaml',
                        help='config YAML (reference schema)')
    parser.add_argument('-s', '--initial_step', default=0, type=int,
                        help='resume step; 0 = latest checkpoint')
    parser.add_argument('--profile', default=None,
                        help='profile step window, e.g. 100:110: a Chrome '
                             'trace per rank under <Log_Path>/profile')
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on (default 'cuda'); "
                             "under data parallelism each rank trains on "
                             "cuda:LOCAL_RANK (or the CPU, over gloo)")
    args = parser.parse_args(argv)
    args.profile_steps = None
    if args.profile:
        try:
            start, stop = args.profile.split(':')
            args.profile_steps = (int(start), int(stop))
        except ValueError:
            parser.error(f'--profile takes START:STOP, two step numbers; '
                         f'got {args.profile!r}')

    from glow_tts_tpu_torch.config import load_config
    from glow_tts_tpu_torch.parallel.data import launched, ranks_to_launch

    config = load_config(args.hyper_parameters)
    ranks = 1 if launched() else ranks_to_launch(config, args.device)
    _launch(_train, args, ranks)


def _launch(run, args: argparse.Namespace, ranks: int) -> None:
    """``run(args)`` in this process, or in ``ranks`` processes started
    here with the environment torchrun would give them."""
    if ranks == 1:
        run(args)
        return
    import torch.multiprocessing as mp
    with socket.socket() as probe:            # a free port on this host
        probe.bind(('localhost', 0))
        port = probe.getsockname()[1]
    mp.spawn(_spawned_rank, args=(run, args, ranks, port), nprocs=ranks)


def _train(args: argparse.Namespace) -> None:
    """One process's run: the whole run, or one rank of it."""
    from glow_tts_tpu_torch.config import load_config
    from glow_tts_tpu_torch.parallel import data
    from glow_tts_tpu_torch.training.trainer import Trainer

    config = load_config(args.hyper_parameters)
    try:
        data.initialize(config, args.device)
        _log_as(data.process_index(), data.process_count())
        Trainer(config, initial_step=args.initial_step,
                device=args.device).train(profile_steps=args.profile_steps)
    finally:
        data.close()


def _log_as(rank: int, ranks: int) -> None:
    """One log of the run: rank 0's, with the other ranks' warnings, each
    line tagged with its rank."""
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format='%(asctime)s '
               + (f'[rank {rank}/{ranks}] ' if ranks > 1 else '')
               + '(%(module)s:%(lineno)d) %(levelname)s: %(message)s')


def _spawned_rank(rank: int, run, args: argparse.Namespace, ranks: int,
                  port: int) -> None:
    """Rank ``rank`` of ``ranks`` started by :func:`_launch`, with the
    environment torchrun would give it."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                      MASTER_ADDR='localhost', MASTER_PORT=str(port))
    run(args)


def infer_main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog='glow-tts-torch-infer')
    parser.add_argument('-c', '--checkpoint', required=True,
                        help='checkpoint directory (with config snapshot)')
    parser.add_argument('-s', '--step', default=0, type=int,
                        help='checkpoint step; 0 = latest')
    parser.add_argument('-f', '--file', default=None,
                        help='TSV inference spec file')
    parser.add_argument('-t', '--text', action='append', default=[],
                        help='inline sentence(s) to synthesise')
    parser.add_argument('-o', '--out_dir', default='./inference_results')
    parser.add_argument('-b', '--batch_size', default=None, type=int)
    parser.add_argument('-wav', '--export_wav', action='store_true',
                        help='also write Griffin-Lim wavs under <out>/WAV')
    parser.add_argument('--device', default='cuda',
                        help="torch device to serve on (default 'cuda')")
    args = parser.parse_args(argv)
    if not args.file and not args.text:
        parser.error('give -f <tsv> or -t <text>')

    from glow_tts_tpu_torch.parallel.data import launched, ranks_to_launch

    ranks = (1 if launched() else ranks_to_launch(
        _serving_config(args.checkpoint), args.device))
    _launch(_infer, args, ranks)


def _serving_config(checkpoint: str):
    """The config of a checkpoint directory's snapshot."""
    from glow_tts_tpu_torch.config import load_config
    from glow_tts_tpu_torch.training.checkpoint import SNAPSHOT
    return load_config(os.path.join(checkpoint, SNAPSHOT))


def _infer(args: argparse.Namespace) -> None:
    """One process's serving: the whole of it, or one rank of the
    ``data × model`` grid (rank 0 prints and writes)."""
    from glow_tts_tpu_torch.inference import Inferencer
    from glow_tts_tpu_torch.parallel import data

    config = _serving_config(args.checkpoint)
    try:
        world = (data.initialize(config, args.device)
                 if data.launched() else data.SINGLE)
        _log_as(world.rank, world.size)
        inferencer = Inferencer(args.checkpoint, config, args.device,
                                batch_size=args.batch_size, step=args.step,
                                world=world)
        _serve(args, inferencer, world)
    finally:
        data.close()


def _serve(args: argparse.Namespace, inferencer, world) -> None:
    if args.file:
        results = inferencer.inference_from_file(args.file, args.out_dir,
                                                 export_wav=args.export_wav)
    else:
        results = inferencer.inference(
            labels=[f'Sentence_{i}' for i in range(len(args.text))],
            texts=args.text, out_dir=args.out_dir,
            export_wav=args.export_wav)
    if world.is_main:
        for r in results:
            print(f"{r['label']}: {r['mel'].shape[0]} frames — "
                  f"{r['text']}")


def patterns_main(argv: Optional[Sequence[str]] = None) -> None:
    """``glow-tts-torch-patterns``: the ETL (``data/pattern_generator.py``)."""
    from glow_tts_tpu_torch.data.pattern_generator import main
    main(argv)


if __name__ == '__main__':
    # ``torchrun ... -m glow_tts_tpu_torch.cli -hp <yaml>`` trains
    train_main()
