"""Batch assembly for the loss and train paths (port of
``glow_tts_tpu/data/collate.py``, the Vanilla fields): tokens padded with
``<E>``, mels truncated to a multiple of ``num_squeeze`` before their
lengths are taken and padded with ``−max_abs_mel``, both axes rounded up to
their buckets (``config.token_bucket`` / ``config.mel_bucket``) so that a
small fixed set of shapes reaches the model.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from glow_tts_tpu_torch.text import Tokenizer


def round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


class TrainCollater:
    """Items (``text`` already filtered, ``mel [T, M]``) → fixed-shape
    numpy batch dict."""

    def __init__(self, config, tokenizer: Tokenizer):
        self.config = config
        self.tokenizer = tokenizer

    def __call__(self, items: Sequence[Dict]) -> Dict[str, np.ndarray]:
        cfg = self.config
        s = cfg.decoder.num_squeeze
        tokens = [self.tokenizer.encode(item['text']) for item in items]
        mels = [item['mel'][:item['mel'].shape[0] // s * s]
                for item in items]

        token_lengths = np.array([t.shape[0] for t in tokens], np.int32)
        mel_lengths = np.array([m.shape[0] for m in mels], np.int32)
        t_tok = round_up(int(token_lengths.max()), cfg.token_bucket)
        t_mel = round_up(int(mel_lengths.max()), cfg.mel_bucket)

        token_pad = np.full((len(items), t_tok), self.tokenizer.eos_id,
                            np.int32)
        mel_pad = np.full((len(items), t_mel, cfg.sound.mel_dim),
                          -cfg.sound.max_abs_mel, np.float32)
        for i, (tk, mel) in enumerate(zip(tokens, mels)):
            token_pad[i, :tk.shape[0]] = tk
            mel_pad[i, :mel.shape[0]] = mel
        return {'tokens': token_pad, 'token_lengths': token_lengths,
                'mels': mel_pad, 'mel_lengths': mel_lengths}
