"""Pattern archives and configs for the PyTorch port's trainer tests,
written with the port's own pattern IO.  Imports neither JAX nor the JAX
package, so the card's tests use it too."""

import dataclasses
import os

import numpy as np


LETTERS = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))


def write_pattern_archive(path, n, sound, seed, mel=(50, 120),
                          text=(10, 30), speakers=2):
    """``n`` synthetic patterns under ``path`` (a folder per speaker,
    pattern i speaker ``i % speakers``) and their ``METADATA.PICKLE`` for
    the config section ``sound``, written with the port's pattern IO:
    texts of ``text`` characters (letters and spaces), mels of ``mel``
    frames uniform in [−4, 4]."""
    from glow_tts_tpu_torch.data.patterns import (build_metadata,
                                                  save_metadata,
                                                  save_pattern)
    rng = np.random.default_rng(seed)
    for i in range(n):
        n_text = int(rng.integers(text[0], text[1] + 1))
        n_mel = int(rng.integers(mel[0], mel[1] + 1))
        chars = rng.choice(LETTERS, n_text)
        chars[3::5] = ' '
        speaker = i % speakers
        save_pattern(os.path.join(path, f'S{speaker}', f'P{i:03d}.PICKLE'), {
            'Audio': np.zeros(n_mel * 4, np.float32),
            'Mel': rng.uniform(-4, 4, (n_mel, sound.mel_dim)
                               ).astype(np.float32),
            'Pitch': rng.random(n_mel).astype(np.float32),
            'Speaker_ID': speaker, 'Speaker': f'S{speaker}',
            'Dataset': 'Synthetic', 'Text': ''.join(chars)})
    save_metadata(path, build_metadata(path, sound))
    return path


def write_inference_tsv(path, texts):
    """An inference TSV (header row, seven columns) of ``texts``."""
    with open(path, 'w', encoding='utf-8') as f:
        f.write('Label\tText\tLength_Scale\tSpeaker\tGE2E\tProsody\tPitch\n')
        for i, text in enumerate(texts):
            f.write(f'L{i}\t{text}\t1.0\t0\tNone\tNone\tNone\n')
    return path


def trainer_config(port_cfg, root, **train):
    """``port_cfg`` training on the archives ``<root>/train`` and
    ``<root>/eval`` with every length filter open, its outputs under
    ``root``; ``train`` overrides fields of ``config.train``."""
    from glow_tts_tpu_torch.config import PatternConfig
    rep = dataclasses.replace

    def pattern(name):
        return PatternConfig(path=os.path.join(root, name),
                             mel_length_min=0, text_length_min=0)
    return rep(port_cfg,
               train=rep(port_cfg.train, train_pattern=pattern('train'),
                         eval_pattern=pattern('eval'), **train),
               checkpoint_path=os.path.join(root, 'checkpoint'),
               log_path=os.path.join(root, 'log'),
               inference_path=os.path.join(root, 'inference'))
