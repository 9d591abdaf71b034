"""MiniSpeech's chain end to end on one card, from its wavs to wavs:

    examples/make_minispeech.py (a subprocess) → the port's ETL
    (``data.pattern_generator``, the DSP on the card) → ``Trainer`` at
    ``configs/MiniSpeech.yaml`` (the EM warmup and the decoder freeze, 80
    flow channels) → ``Inferencer.synthesize_items(export_wav=True)`` on
    held-out texts → Griffin-Lim wavs.

    python -m glow_tts_tpu_torch.tools.minispeech_e2e [--n 2000]
        [--steps 9000] [--root DIR] [--corpus DIR] [--out DIR]
        [--eval-texts 4] [--device cuda]

``--steps`` defaults to the YAML's ``Max_Step``; ``--corpus`` skips the
corpus's synthesis; ``--root`` (default: a new temporary directory) holds
the corpus, the patterns and the run's checkpoints and logs.  It prints,
and writes to ``<out>/summary.json``, one JSON object: the free-running
length error against the corpus's deterministic phone durations, the
phone-signature correlation of the synthesised mels (the keys of
``examples/minispeech_e2e.py``), the real-time factors of the mel
synthesis alone and with the Griffin-Lim export, the ETL's and the
training's wall time, the eval trajectory (MLE, duration loss and
attention diagonality every ``Evaluation_Interval``) and the card's name
and power limit.  Each logged step is also appended to
``<out>/trajectory.jsonl`` while it trains.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import pickle
import random
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Dict, List, Mapping

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MINISPEECH = os.path.join(REPO, 'configs', 'MiniSpeech.yaml')
MAKE_CORPUS = os.path.join(REPO, 'examples', 'make_minispeech.py')

# the corpus's phone table (examples/make_minispeech.py; a CPU test holds
# this copy equal to it)
LETTERS = 'ABCDEFGHIJ'
PAUSE_FRAMES = 12


def phone_params(i: int):
    """Per-letter synthesis parameters: f0, two formants, noise level,
    duration in mel frames."""
    f0 = 110.0 + 14.0 * i
    f1 = 350.0 + 80.0 * ((i * 3) % 7)
    f2 = 900.0 + 180.0 * ((i * 5) % 9)
    noise = 0.02 + 0.08 * ((i * 7) % 10) / 9.0
    dur_frames = 14 + 2 * (i % 4)
    return f0, f1, f2, noise, dur_frames


def expected_frames(text: str) -> int:
    """The frames the corpus's generator gives ``text``."""
    return sum(PAUSE_FRAMES if ch == ' ' else
               phone_params(LETTERS.index(ch))[4] for ch in text)


def make_corpus(out: str, n: int, seed: int) -> None:
    subprocess.run([sys.executable, MAKE_CORPUS, '--n', str(n), '--out', out,
                    '--seed', str(seed)], check=True)


def minispeech_config(root: str, steps: int = 0):
    """``configs/MiniSpeech.yaml`` with its paths under ``root`` and
    ``Max_Step`` = ``steps`` (0: the YAML's)."""
    from glow_tts_tpu_torch.config import load_config
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')          # bf16 → f32 (A.5)
        config = load_config(MINISPEECH)
    patterns = os.path.join(root, 'patterns')
    train = config.train
    train = dataclasses.replace(
        train, max_step=steps or train.max_step,
        train_pattern=dataclasses.replace(
            train.train_pattern, path=os.path.join(patterns, 'Train')),
        eval_pattern=dataclasses.replace(
            train.eval_pattern, path=os.path.join(patterns, 'Eval')))
    results = os.path.join(root, 'results')
    return dataclasses.replace(
        config, train=train, token_path=os.path.join(patterns, 'Token.yaml'),
        checkpoint_path=os.path.join(results, 'Checkpoint'),
        log_path=os.path.join(results, 'Log'),
        inference_path=os.path.join(results, 'Inference'))


def pattern_files(pattern_root: str) -> List[str]:
    return [f for f in sorted(glob.glob(os.path.join(
        pattern_root, '**', '*.PICKLE'), recursive=True))
        if os.path.basename(f) != 'METADATA.PICKLE']


def eval_texts(pattern_root: str, n: int) -> List[Dict]:
    """``n`` held-out texts (never trained on), labelled by utterance."""
    items = []
    for f in pattern_files(pattern_root):
        with open(f, 'rb') as fh:
            pattern = pickle.load(fh)
        if 'Text' in pattern:
            items.append({'label': os.path.basename(f).split('.')[1],
                          'text': pattern['Text']})
        if len(items) >= n:
            break
    return items


def phone_signatures(pattern_root: str, max_files: int = 16):
    """Each letter's mean mel over the eval patterns, sliced by the
    generator's deterministic durations (2 frames off each edge)."""
    sums = {ch: 0.0 for ch in LETTERS}
    counts = {ch: 0 for ch in LETTERS}
    for f in pattern_files(pattern_root)[:max_files]:
        with open(f, 'rb') as fh:
            pattern = pickle.load(fh)
        mel, pos = pattern['Mel'], 0
        for ch in pattern['Text']:
            d = PAUSE_FRAMES if ch == ' ' else phone_params(
                LETTERS.index(ch))[4]
            if ch != ' ' and pos + d <= mel.shape[0]:
                sums[ch] = sums[ch] + mel[pos + 2:pos + d - 2].mean(axis=0)
                counts[ch] += 1
            pos += d
    return {ch: sums[ch] / counts[ch] for ch in LETTERS if counts[ch]}


def score(results: List[Mapping], signatures: Mapping) -> Dict:
    """The free-running length error against the generator's durations,
    and the correlation of each synthesised phone's mean mel (sliced by
    the predicted durations) with its letter's signature."""
    length_errors, correlations = [], []
    for result in results:
        expected = expected_frames(result['text'])
        length_errors.append(abs(result['mel'].shape[0] - expected)
                             / expected)
        durations = result['attention'].sum(axis=1).astype(int)
        pos = 0
        for token, d in zip(['<S>', *result['text'], '<E>'], durations):
            if token in signatures and d >= 6:
                segment = result['mel'][pos + 2:pos + d - 2].mean(axis=0)
                correlations.append(float(np.corrcoef(
                    segment, signatures[token])[0, 1]))
            pos += int(d)
    return {
        'free_run_length_rel_err': float(np.mean(length_errors)),
        'phone_signature_corr_mean': (float(np.mean(correlations))
                                      if correlations else None),
        'phone_signature_corr_min': (float(np.min(correlations))
                                     if correlations else None),
        'n_phones_checked': len(correlations)}


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as error:
        return f'nvidia-smi unavailable ({error})'


class TrajectoryWriter:
    """Keeps the scalars (``utils.logging.MemoryWriter``) and appends each
    call's as one JSON line to ``path``."""

    def __init__(self, path: str, kind: str):
        from glow_tts_tpu_torch.utils.logging import MemoryWriter
        self.memory, self.path, self.kind = MemoryWriter(), path, kind

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        self.memory.add_scalars(scalars, step)
        with open(self.path, 'a', encoding='utf-8') as f:
            f.write(json.dumps({'kind': self.kind, 'step': int(step),
                                **{k: float(v) for k, v in scalars.items()}})
                    + '\n')

    def __getattr__(self, name):         # images, histograms: not written
        return getattr(self.memory, name)


def eval_trajectory(writer: TrajectoryWriter) -> List[Dict]:
    scalars = writer.memory.scalars
    rows = {}
    for tag, key in (('Loss/mle', 'mle'), ('Loss/duration', 'duration'),
                     ('Alignment/diagonality', 'attention_diagonality')):
        for step, value in scalars.get(tag, []):
            rows.setdefault(step, {'step': step})[key] = value
    return [rows[step] for step in sorted(rows)]


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(prog='minispeech_e2e')
    parser.add_argument('--n', type=int, default=2000,
                        help='utterances of the corpus to make')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--corpus', default=None,
                        help='an existing corpus (skips its synthesis)')
    parser.add_argument('--root', default=None)
    parser.add_argument('--out', default=None,
                        help='wavs, mels and summary.json (default '
                             '<root>/export)')
    parser.add_argument('--steps', type=int, default=0,
                        help="train steps (default: the YAML's Max_Step)")
    parser.add_argument('--eval-ratio', type=float, default=0.01)
    parser.add_argument('--eval-min', type=int, default=8)
    parser.add_argument('--eval-texts', type=int, default=4)
    parser.add_argument('--workers', type=int, default=10,
                        help="the ETL's threads")
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from glow_tts_tpu_torch import Inferencer, Trainer
    from glow_tts_tpu_torch.data.pattern_generator import generate_patterns
    from glow_tts_tpu_torch.ops.stft import card_or_cpu
    from glow_tts_tpu_torch.training.checkpoint import CheckpointManager
    device = card_or_cpu(args.device)
    root = args.root or tempfile.mkdtemp(prefix='minispeech_')
    out = args.out or os.path.join(root, 'export')
    os.makedirs(out, exist_ok=True)
    config = minispeech_config(root, args.steps)
    summary: Dict = {'card': card_line() if device.type == 'cuda' else 'cpu',
                     'device': str(device), 'steps': config.train.max_step}

    start = time.perf_counter()
    corpus = args.corpus or os.path.join(root, 'corpus')
    if args.corpus is None:
        make_corpus(corpus, args.n, args.seed)
    summary['corpus_sec'] = time.perf_counter() - start

    start = time.perf_counter()
    random.seed(args.seed)                       # the train/eval split
    generate_patterns(config, {'LJ': corpus}, use_text=True,
                      eval_ratio=args.eval_ratio, eval_min=args.eval_min,
                      max_workers=args.workers, device=device)
    etl = time.perf_counter() - start
    n_patterns = {split: len(pattern_files(path)) for split, path in (
        ('train', config.train.train_pattern.path),
        ('eval', config.train.eval_pattern.path))}
    summary.update(etl_sec=etl, patterns=n_patterns,
                   etl_ms_per_utterance=1e3 * etl / sum(n_patterns.values()))
    print(json.dumps({'etl': summary}), flush=True)

    trajectory = os.path.join(out, 'trajectory.jsonl')
    if os.path.exists(trajectory):
        os.remove(trajectory)
    writers = {kind: TrajectoryWriter(trajectory, kind)
               for kind in ('train', 'eval')}
    start = time.perf_counter()
    trainer = Trainer(config, device=device, writers=writers)
    trainer.train()
    summary['train_sec'] = time.perf_counter() - start
    summary['eval_trajectory'] = eval_trajectory(writers['eval'])
    del trainer
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    step = CheckpointManager(config.checkpoint_path).latest_step()
    inferencer = Inferencer(config.checkpoint_path, config, device,
                            max_mel_length=1024, step=step)
    items = eval_texts(config.train.eval_pattern.path, args.eval_texts)
    if not items:
        raise RuntimeError(f'no eval patterns under '
                           f'{config.train.eval_pattern.path}')
    # warm-up, the export's too (cuFFT plans for each length)
    with tempfile.TemporaryDirectory() as warm:
        inferencer.synthesize_items(items, out_dir=warm, export_wav=True)
    start = time.perf_counter()
    inferencer.synthesize_items(items)
    mel_wall = time.perf_counter() - start
    start = time.perf_counter()
    results = inferencer.synthesize_items(items, out_dir=out,
                                          export_wav=True)
    full_wall = time.perf_counter() - start
    sound = config.sound
    audio_sec = (sum(r['mel'].shape[0] for r in results) * sound.frame_shift
                 / sound.sample_rate)
    summary.update({
        'checkpoint_step': step,
        'n_utterances': len(results),
        'texts': [r['text'] for r in results],
        'mel_synthesis_wall_sec': mel_wall,
        'full_export_wall_sec': full_wall,
        'audio_seconds': audio_sec,
        'rtf_mel': mel_wall / audio_sec,
        'rtf_total_with_vocoder_export': full_wall / audio_sec,
        **score(results, phone_signatures(config.train.eval_pattern.path)),
        'wav_samples': [int(r['audio'].shape[0]) for r in results],
        'mel_frames': [int(r['mel'].shape[0]) for r in results],
        'expected_frames': [expected_frames(r['text']) for r in results]})
    with open(os.path.join(out, 'summary.json'), 'w', encoding='utf-8') as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == '__main__':
    main()
