"""Batch assembly (port of ``glow_tts_tpu/data/collate.py``): tokens padded
with ``<E>``, mels truncated to a multiple of ``num_squeeze`` before their
lengths are taken and padded with ``−max_abs_mel``, both axes rounded up to
their buckets (``config.token_bucket`` / ``config.mel_bucket``) so that a
small fixed set of shapes reaches the model.  :class:`TrainCollater` has
the fields of the loss and train paths in all four modes (speaker ids, GE2E
slices of the training mel, the pitch track on the mel's timeline);
:class:`InferenceCollater` the serving fields of all four modes: speaker
ids, GE2E slices of a reference mel, a reference mel for the prosody
encoder, a pitch track; :class:`ProsodyCheckCollater` the reference mels of
the prosody check.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from glow_tts_tpu_torch.text import Tokenizer


def round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def batch_rng(seed: int, items: Sequence[Dict],
              mel_key: str = 'mel') -> np.random.Generator:
    """A generator for the GE2E slice offsets of one batch, seeded from
    ``seed`` and the batch's content (each item's mel length and speaker
    id): the same batch gets the same offsets whichever thread assembles
    it and in whatever order."""
    fingerprint = [np.uint32(seed) & 0xFFFFFFFF]
    for item in items:
        mel = item.get(mel_key)
        if mel is not None:
            fingerprint.append(mel.shape[0])
        fingerprint.append(int(item.get('speaker_id', 0)))
    return np.random.default_rng(np.random.SeedSequence(fingerprint))


def slice_mel_for_ge2e(mel: np.ndarray, samples: int, slice_length: int,
                       overlap_length: int,
                       rng: np.random.Generator) -> np.ndarray:
    """``[T, M]`` → ``[samples, slice_length, M]`` overlapping windows of a
    random stretch of the mel, or of the whole mel reflect-padded when it
    is too short."""
    required = samples * (slice_length - overlap_length) + overlap_length
    if mel.shape[0] > required:
        offset = int(rng.integers(0, mel.shape[0] - required))
        mel = mel[offset:offset + required]
    else:
        pad = (required - mel.shape[0]) / 2
        mel = np.pad(mel, [[int(np.floor(pad)), int(np.ceil(pad))], [0, 0]],
                     mode='reflect')
    step = slice_length - overlap_length
    return np.stack([mel[i * step:i * step + slice_length]
                     for i in range(samples)])


def _pad_rows(rows: Sequence[np.ndarray], multiple: int, value: float,
              width: Sequence[int] = ()):
    """Arrays ``[T_i, *width]`` → ``([B, T, *width]`` padded with ``value``
    to ``T``, the longest rounded up to ``multiple``; lengths ``[B]``)."""
    lengths = np.array([r.shape[0] for r in rows], np.int32)
    padded = np.full((len(rows), round_up(int(lengths.max()), multiple),
                      *width), value, np.float32)
    for i, r in enumerate(rows):
        padded[i, :r.shape[0]] = r
    return padded, lengths


class TrainCollater:
    """Items (``text`` already filtered, ``mel [T, M]``; by mode
    ``speaker_id``, ``pitch [T]``) → fixed-shape numpy batch dict:
    ``tokens``, ``token_lengths``, ``mels``, ``mel_lengths`` and, by mode,
    ``speakers`` (SE, GR), ``mels_for_ge2e [B·S, T_slice, M]`` (GE2E
    slices of each training mel, offsets from ``batch_rng(seed, items)``)
    and ``pitches [B, T_mel]`` (GR: zero-padded, cut to the truncated mel
    length)."""

    def __init__(self, config, tokenizer: Tokenizer, seed: int = 0):
        self.config = config
        self.tokenizer = tokenizer
        self.seed = seed

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
        out = {'tokens': token_pad, 'token_lengths': token_lengths,
               'mels': mel_pad, 'mel_lengths': mel_lengths}
        if cfg.uses_speaker_embedding:
            out['speakers'] = np.array(
                [item['speaker_id'] for item in items], np.int32)
        if cfg.uses_ge2e:
            ge2e = cfg.speaker_embedding.ge2e.inference
            rng = batch_rng(self.seed, items)
            out['mels_for_ge2e'] = np.concatenate([
                slice_mel_for_ge2e(item['mel'], ge2e.samples,
                                   ge2e.slice_length, ge2e.overlap_length,
                                   rng)
                for item in items]).astype(np.float32)
        if cfg.uses_gradient_reversal:
            # the pitch on the (truncated) mel's timeline
            pitch_pad = np.zeros((len(items), t_mel), np.float32)
            for i, (item, mel) in enumerate(zip(items, mels)):
                n = min(item['pitch'].shape[0], mel.shape[0])
                pitch_pad[i, :n] = item['pitch'][:n]
            out['pitches'] = pitch_pad
        return out


class InferenceCollater:
    """Serving items (``text`` filtered, optional ``length_scale``, and per
    mode ``speaker_id``, ``mel_for_ge2e [T, M]``, ``mel_for_prosody
    [T, M]``, ``pitch [T]`` as arrays) → numpy batch dict: ``tokens``,
    ``token_lengths``, ``length_scales``, and by mode ``speakers``,
    ``mels_for_ge2e [B·S, T_slice, M]``, ``mels_for_prosody`` (padded with
    ``−max_abs_mel``) with ``mel_lengths_for_prosody``, ``pitches`` (padded
    with 0) with ``pitch_lengths``, both padded to a multiple of
    ``config.mel_bucket``."""

    def __init__(self, config, tokenizer: Tokenizer, seed: int = 0):
        self.config = config
        self.tokenizer = tokenizer
        self.seed = seed

    def __call__(self, items: Sequence[Dict]) -> Dict[str, np.ndarray]:
        cfg = self.config
        tokens, token_lengths = self.tokenizer.encode_batch(
            [item['text'] for item in items])
        t_tok = round_up(tokens.shape[1], cfg.token_bucket)
        out = {
            'tokens': np.pad(tokens, ((0, 0), (0, t_tok - tokens.shape[1])),
                             constant_values=self.tokenizer.eos_id),
            'token_lengths': token_lengths,
            'length_scales': np.array(
                [item.get('length_scale', 1.0) for item in items],
                np.float32)}
        if cfg.uses_speaker_embedding and not cfg.uses_ge2e:
            out['speakers'] = np.array(
                [item['speaker_id'] for item in items], np.int32)
        if cfg.uses_ge2e:
            ge2e = cfg.speaker_embedding.ge2e.inference
            rng = batch_rng(self.seed, items, mel_key='mel_for_ge2e')
            out['mels_for_ge2e'] = np.concatenate([
                slice_mel_for_ge2e(item['mel_for_ge2e'], ge2e.samples,
                                   ge2e.slice_length, ge2e.overlap_length,
                                   rng)
                for item in items]).astype(np.float32)
        if cfg.uses_prosody_encoder:
            out['mels_for_prosody'], out['mel_lengths_for_prosody'] = \
                _pad_rows([item['mel_for_prosody'] for item in items],
                          cfg.mel_bucket, -cfg.sound.max_abs_mel,
                          (cfg.sound.mel_dim,))
        if cfg.uses_gradient_reversal:
            out['pitches'], out['pitch_lengths'] = _pad_rows(
                [item['pitch'] for item in items], cfg.mel_bucket, 0.0)
        return out


class ProsodyCheckCollater:
    """Prosody-check items (``mel [T, M]``, ``speaker``) → ``mels [B, T,
    M]`` padded with ``−max_abs_mel`` to the longest rounded up to
    ``config.mel_bucket``, ``mel_lengths [B]`` and the speakers as
    ``labels``."""

    def __init__(self, config):
        self.config = config

    def __call__(self, items: Sequence[Dict]) -> Dict:
        cfg = self.config
        mels, lengths = _pad_rows([item['mel'] for item in items],
                                  cfg.mel_bucket, -cfg.sound.max_abs_mel,
                                  (cfg.sound.mel_dim,))
        return {'mels': mels, 'mel_lengths': lengths,
                'labels': [item['speaker'] for item in items]}
