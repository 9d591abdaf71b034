"""Serving front end (port of ``glow_tts_tpu/inference.py``, Vanilla mode).

``Inferencer`` loads reference-format weights onto an explicit device and
synthesises mels two-phase and mel-bucketed: the prior phase predicts the
durations, the host picks the smallest mel bucket the batch fits, and the
decode phase runs at that capacity.  PNG/NPY export and reference-wav
features are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch

from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.text import Tokenizer, load_token_dict, text_filtering
from glow_tts_tpu_torch.weights import (load_reference_checkpoint,
                                        load_state_dict)


def bucket_ladder(max_mel_length: int, num_squeeze: int,
                  mel_buckets: Optional[Sequence[int]] = None) -> List[int]:
    """Static decode capacities: by default powers of two from 128 below
    ``max_mel_length``, plus ``max_mel_length`` itself, each a multiple of
    ``num_squeeze``."""
    if mel_buckets is None:
        mel_buckets, b = [], 128
        while b < max_mel_length:
            mel_buckets.append(b)
            b *= 2
    s = num_squeeze
    return sorted({min(max(int(b) // s * s, s), max_mel_length)
                   for b in mel_buckets} | {max_mel_length})


class Inferencer:
    """``weights``: a reference-format state dict, or the path of an
    ``S_<step>.pt`` checkpoint.  ``device`` is required: a CUDA device
    runs the flow kernel of ``config.coupling_backend``'s route, a CPU
    device that kernel's plain version."""

    def __init__(self, weights: Union[str, os.PathLike, Mapping],
                 config, device: Union[str, torch.device],
                 batch_size: Optional[int] = None,
                 max_mel_length: int = 1024,
                 mel_buckets: Optional[Sequence[int]] = None):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {self.device} requested but CUDA '
                               f'is not available')
        self.config = config
        self.batch_size = (batch_size or config.inference_batch_size
                           or config.train.batch_size)
        self.mel_buckets = bucket_ladder(
            max_mel_length, config.decoder.num_squeeze, mel_buckets)
        token_dict = None
        if config.token_path and os.path.exists(config.token_path):
            token_dict = load_token_dict(config.token_path)
        self.tokenizer = Tokenizer(token_dict)

        if not isinstance(weights, Mapping):
            weights = load_reference_checkpoint(weights)
        self.model = load_state_dict(GlowTTS(config), weights)
        self.model.to(self.device).prepare()

    def pick_bucket(self, durations: torch.Tensor) -> int:
        """Smallest bucket holding the longest utterance (host sync)."""
        need = int(durations.sum(dim=1).max())
        return next((b for b in self.mel_buckets if b >= need),
                    self.mel_buckets[-1])

    def collate(self, items: Sequence[Dict]):
        """Items → (tokens [B, T_tok], token_lengths [B], length_scales
        [B]) on the device, the token axis padded with ``<E>`` to a
        multiple of ``config.token_bucket``."""
        texts = [item['text'] for item in items]
        longest = max(len(text) for text in texts) + 2      # <S> … <E>
        bucket = self.config.token_bucket
        tokens, lengths = self.tokenizer.encode_batch(
            texts, pad_to=-(-longest // bucket) * bucket)
        scales = [float(item.get('length_scale', 1.0)) for item in items]
        return (torch.as_tensor(tokens, dtype=torch.long, device=self.device),
                torch.as_tensor(lengths, dtype=torch.long, device=self.device),
                torch.tensor(scales, dtype=torch.float32, device=self.device))

    def synthesize_items(self, items: Sequence[Dict],
                         noise_scale: float = 1.0,
                         seed: int = 0) -> List[Dict]:
        """Items with ``text`` (filtered), optional ``label`` and
        ``length_scale`` → one result per item: its ``mel [T, M]``,
        ``attention [T_tok, T]`` and the ``bucket`` its batch decoded in.
        Batch ``start`` draws its noise from a generator seeded with
        ``seed + start``."""
        results = []
        for start in range(0, len(items), self.batch_size):
            chunk = list(items[start:start + self.batch_size])
            tokens, lengths, scales = self.collate(chunk)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed + start)
            prior = self.model.inference_prior(tokens, lengths, scales)
            bucket = self.pick_bucket(prior['durations'])
            out = self.model.inference_decode(
                prior, generator=generator, noise_scale=noise_scale,
                max_mel_length=bucket)
            mels = out['mels'].cpu().numpy()
            mel_lengths = out['mel_lengths'].cpu().numpy()
            attentions = out['attentions'].cpu().numpy()
            for i, item in enumerate(chunk):
                n_mel, n_tok = int(mel_lengths[i]), int(lengths[i])
                results.append({
                    'label': item.get('label', str(start + i)),
                    'text': item['text'],
                    'mel': mels[i, :n_mel],
                    'attention': attentions[i, :n_tok, :n_mel],
                    'bucket': bucket,
                })
        return results

    def inference(self, labels: Sequence[str], texts: Sequence[str],
                  length_scales: Optional[Sequence[float]] = None,
                  noise_scale: float = 1.0, seed: int = 0) -> List[Dict]:
        """Programmatic batch synthesis; texts the filter rejects are
        skipped, as in the JAX package."""
        items = []
        for i, text in enumerate(texts):
            filtered = text_filtering(text)
            if filtered is None:
                continue
            items.append({'label': labels[i], 'text': filtered,
                          'length_scale': (length_scales[i] if length_scales
                                           else 1.0)})
        return self.synthesize_items(items, noise_scale, seed)
