"""Console entry points of the port (``pyproject.toml``:
``glow-tts-torch-train``, ``glow-tts-torch-infer``, and
``glow-tts-torch-patterns``, the ETL of ``data/pattern_generator.py``),
with the flags of ``glow_tts_tpu/cli.py`` and ``--device`` (default
``cuda``; it raises where CUDA is absent).

    glow-tts-torch-patterns -hp configs/MiniSpeech.yaml -lj corpus -text
    glow-tts-torch-train -hp configs/Hyper_Parameters.yaml [-s STEP]
    glow-tts-torch-infer -c results/Checkpoint [-s STEP] -f lines.tsv -o out
        [-wav]
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence


def train_main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog='glow-tts-torch-train')
    parser.add_argument('-hp', '--hyper_parameters',
                        default='configs/Hyper_Parameters.yaml',
                        help='config YAML (reference schema)')
    parser.add_argument('-s', '--initial_step', default=0, type=int,
                        help='resume step; 0 = latest checkpoint')
    parser.add_argument('--profile', default=None,
                        help='profile step window: not in the PyTorch port '
                             'yet')
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on (default 'cuda')")
    args = parser.parse_args(argv)
    if args.profile:
        parser.error('--profile is not in the PyTorch port yet')

    logging.basicConfig(
        level=logging.INFO,
        format='%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: '
               '%(message)s')
    from glow_tts_tpu_torch.config import load_config
    from glow_tts_tpu_torch.training.trainer import Trainer

    config = load_config(args.hyper_parameters)
    Trainer(config, initial_step=args.initial_step,
            device=args.device).train()


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

    logging.basicConfig(level=logging.INFO)
    from glow_tts_tpu_torch.inference import Inferencer

    inferencer = Inferencer(args.checkpoint, None, args.device,
                            batch_size=args.batch_size, step=args.step)
    if args.file:
        results = inferencer.inference_from_file(args.file, args.out_dir,
                                                 export_wav=args.export_wav)
    else:
        results = inferencer.inference(
            labels=[f'Sentence_{i}' for i in range(len(args.text))],
            texts=args.text, out_dir=args.out_dir,
            export_wav=args.export_wav)
    for r in results:
        print(f"{r['label']}: {r['mel'].shape[0]} frames — {r['text']}")


def patterns_main(argv: Optional[Sequence[str]] = None) -> None:
    """``glow-tts-torch-patterns``: the ETL (``data/pattern_generator.py``)."""
    from glow_tts_tpu_torch.data.pattern_generator import main
    main(argv)
