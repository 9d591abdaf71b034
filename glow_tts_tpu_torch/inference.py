"""Serving front end (port of ``glow_tts_tpu/inference.py``), in the four
modes.

``Inferencer`` loads reference-format weights onto a device (the card
unless the caller asks for the CPU) and synthesises mels two-phase and
mel-bucketed: the prior phase predicts the durations, the host picks the
smallest mel bucket the batch fits, and the decode phase runs at that
capacity.  The conditioned modes read, per item, a ``speaker_id`` (SE and
GR with the look-up table) and reference features: ``mel_for_ge2e``
(GE2E), ``mel_for_prosody`` (PE, GR) and ``pitch`` (GR), as arrays or made
on the ``Inferencer``'s device from the reference wavs the item names
(``wav_for_ge2e``, ``wav_for_prosody``, ``wav_for_pitch``;
``data.pattern_generator.load_reference_features``).  Results can be
exported as the NPY tree (``utils.plotting.export_npy``) and as Griffin-Lim
wavs (``ops.vocoder``, on the same device); PNG figures are not ported
yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from glow_tts_tpu_torch.config import load_config
from glow_tts_tpu_torch.data.collate import InferenceCollater
from glow_tts_tpu_torch.data.pattern_generator import \
    load_reference_features
from glow_tts_tpu_torch.data.patterns import InferenceDataset
from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.ops import vocoder
from glow_tts_tpu_torch.text import Tokenizer, load_token_dict, text_filtering
from glow_tts_tpu_torch.training.checkpoint import SNAPSHOT, CheckpointManager
from glow_tts_tpu_torch.utils.plotting import export_npy
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
    """``weights``: a reference-format state dict, the path of an
    ``S_<step>.pt`` checkpoint, or a checkpoint directory, whose
    ``S_<step>.pt`` is read (``step=0``: the highest step).  ``config``
    may be ``None`` for a directory: its ``Hyper_Parameters.yaml``
    snapshot is read.  ``device`` is the card unless the caller asks for
    the CPU: a CUDA device runs the flow kernel of
    ``config.coupling_backend``'s route, a CPU device that kernel's plain
    version."""

    def __init__(self, weights: Union[str, os.PathLike, Mapping],
                 config=None, device: Union[str, torch.device] = 'cuda',
                 batch_size: Optional[int] = None,
                 max_mel_length: int = 1024,
                 mel_buckets: Optional[Sequence[int]] = None,
                 step: int = 0):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {self.device} requested but CUDA '
                               f'is not available')
        if not isinstance(weights, Mapping) and os.path.isdir(weights):
            if config is None:
                snapshot = os.path.join(weights, SNAPSHOT)
                if not os.path.exists(snapshot):
                    raise FileNotFoundError(
                        f'{weights!r} holds no {SNAPSHOT} snapshot: pass '
                        f'config= explicitly')
                config = load_config(snapshot)
            checkpoints = CheckpointManager(weights)
            target = step or checkpoints.latest_step()
            if target not in checkpoints.steps():
                raise FileNotFoundError(
                    f'no checkpoint of step {step} in {weights!r} (steps: '
                    f'{checkpoints.steps()})')
            weights = checkpoints.path(target)
        if config is None:
            raise ValueError('config is needed unless weights is a '
                             'checkpoint directory')
        self.config = config
        self.batch_size = (batch_size or config.inference_batch_size
                           or config.train.batch_size)
        self.mel_buckets = bucket_ladder(
            max_mel_length, config.decoder.num_squeeze, mel_buckets)
        token_dict = None
        if config.token_path and os.path.exists(config.token_path):
            token_dict = load_token_dict(config.token_path)
        self.tokenizer = Tokenizer(token_dict)
        self.collater = InferenceCollater(config, self.tokenizer)

        if not isinstance(weights, Mapping):
            weights = load_reference_checkpoint(weights)
        self.model = load_state_dict(GlowTTS(config), weights)
        self.model.to(self.device).prepare()

    def pick_bucket(self, durations: torch.Tensor) -> int:
        """Smallest bucket holding the longest utterance (host sync)."""
        need = int(durations.sum(dim=1).max())
        return next((b for b in self.mel_buckets if b >= need),
                    self.mel_buckets[-1])

    # per mode: the array an item carries, and the wav it can be made of
    _FEATURES = (('uses_ge2e', 'mel_for_ge2e', 'wav_for_ge2e'),
                 ('uses_prosody_encoder', 'mel_for_prosody',
                  'wav_for_prosody'),
                 ('uses_gradient_reversal', 'pitch', 'wav_for_pitch'))

    def with_features(self, item: Mapping) -> Mapping:
        """``item`` with the reference features its mode needs: made on
        the device from the reference wavs it names (each of the mode's
        wavs, as the JAX package makes them), else as it carries them.
        Raises ``ValueError`` where a feature is neither given nor
        named."""
        needed = [(key, wav) for mode, key, wav in self._FEATURES
                  if getattr(self.config, mode)]
        if needed and all(item.get(wav) for _, wav in needed):
            item = load_reference_features(self.config, item, self.device)
        for key, _ in needed:
            if item.get(key) is None:
                raise ValueError(f'{self.config.mode} mode needs {key!r} '
                                 f'(or the reference wav it is made of) on '
                                 f'every item (label {item.get("label")!r})')
        return item

    def batch(self, items: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        """Items → the ``InferenceCollater`` batch as tensors on the
        device: ``tokens [B, T_tok]`` (padded with ``<E>`` to a multiple of
        ``config.token_bucket``), ``token_lengths``, ``length_scales`` and
        the mode's conditioning inputs."""
        items = [self.with_features(item) for item in items]
        batch = {}
        for key, value in self.collater(items).items():
            dtype = (torch.long if np.issubdtype(value.dtype, np.integer)
                     else torch.float32)
            batch[key] = torch.as_tensor(value, dtype=dtype,
                                         device=self.device)
        return batch

    def collate(self, items: Sequence[Dict]):
        """Items → (tokens [B, T_tok], token_lengths [B], length_scales
        [B]) on the device: :meth:`batch`'s first three."""
        batch = self.batch(items)
        return (batch['tokens'], batch['token_lengths'],
                batch['length_scales'])

    def synthesize_items(self, items: Sequence[Dict],
                         noise_scale: float = 1.0,
                         seed: int = 0,
                         out_dir: Optional[str] = None,
                         export_wav: bool = False,
                         griffin_lim_iterations: int = 60) -> List[Dict]:
        """Items with ``text`` (filtered), optional ``label`` and
        ``length_scale`` → one result per item: its ``mel [T, M]``,
        ``attention [T_tok, T]`` and the ``bucket`` its batch decoded in,
        each also written under ``out_dir`` by ``export_npy`` if given;
        with ``export_wav`` as well, the Griffin-Lim waveform
        (``griffin_lim_iterations`` on the device, the start phase from
        seed 0) in ``result['audio']`` and ``<out_dir>/WAV/<label>.wav``.
        Batch ``start`` draws its noise from a generator seeded with
        ``seed + start``.  The conditioned modes' items carry their
        ``speaker_id`` and reference features or wavs (module
        docstring)."""
        results = []
        for start in range(0, len(items), self.batch_size):
            chunk = list(items[start:start + self.batch_size])
            batch = self.batch(chunk)
            lengths = batch['token_lengths']
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed + start)
            prior = self.model.inference_prior(
                batch['tokens'], lengths, batch['length_scales'],
                batch.get('mels_for_prosody'),
                batch.get('mel_lengths_for_prosody'), batch.get('speakers'),
                batch.get('mels_for_ge2e'))
            bucket = self.pick_bucket(prior['durations'])
            out = self.model.inference_decode(
                prior, generator=generator, noise_scale=noise_scale,
                max_mel_length=bucket, pitches=batch.get('pitches'),
                pitch_lengths=batch.get('pitch_lengths'))
            mels = out['mels'].cpu().numpy()
            mel_lengths = out['mel_lengths'].cpu().numpy()
            attentions = out['attentions'].cpu().numpy()
            for i, item in enumerate(chunk):
                n_mel, n_tok = int(mel_lengths[i]), int(lengths[i])
                result = {
                    'label': item.get('label', str(start + i)),
                    'text': item['text'],
                    'mel': mels[i, :n_mel],
                    'attention': attentions[i, :n_tok, :n_mel],
                    'bucket': bucket,
                }
                results.append(result)
                if out_dir:
                    export_npy(out_dir, result['label'], result['mel'],
                               result['attention'])
                    if export_wav:
                        sound = self.config.sound
                        result['audio'] = vocoder.mel_to_audio(
                            result['mel'], sound, griffin_lim_iterations,
                            device=self.device)
                        vocoder.save_wav(
                            os.path.join(out_dir, 'WAV',
                                         f'{result["label"]}.wav'),
                            result['audio'], sound.sample_rate)
        return results

    def inference(self, labels: Sequence[str], texts: Sequence[str],
                  length_scales: Optional[Sequence[float]] = None,
                  noise_scale: float = 1.0, seed: int = 0,
                  out_dir: Optional[str] = None,
                  speakers: Optional[Sequence[int]] = None,
                  wavs_for_ge2e: Optional[Sequence[str]] = None,
                  wavs_for_prosody: Optional[Sequence[str]] = None,
                  wavs_for_pitch: Optional[Sequence[str]] = None,
                  export_wav: bool = False) -> List[Dict]:
        """Programmatic batch synthesis; texts the filter rejects are
        skipped, as in the JAX package.  ``speakers`` are the speaker ids
        of the look-up-table modes (default 0); ``wavs_for_*`` the
        reference wavs of the modes that read their features."""
        items = []
        for i, text in enumerate(texts):
            filtered = text_filtering(text)
            if filtered is None:
                continue
            items.append({
                'label': labels[i], 'text': filtered,
                'length_scale': (length_scales[i] if length_scales
                                 else 1.0),
                'speaker_id': (int(speakers[i]) if speakers is not None
                               else 0),
                'wav_for_ge2e': wavs_for_ge2e[i] if wavs_for_ge2e else None,
                'wav_for_prosody': (wavs_for_prosody[i] if wavs_for_prosody
                                    else None),
                'wav_for_pitch': wavs_for_pitch[i] if wavs_for_pitch else None})
        return self.synthesize_items(items, noise_scale, seed, out_dir,
                                     export_wav=export_wav)

    def inference_from_file(self, tsv_path: str,
                            out_dir: Optional[str] = None,
                            export_wav: bool = False) -> List[Dict]:
        """The sentences of an inference TSV (``data.patterns.
        InferenceDataset``), with their speaker ids and reference wavs."""
        return self.synthesize_items(InferenceDataset(tsv_path).entries,
                                     out_dir=out_dir, export_wav=export_wav)
