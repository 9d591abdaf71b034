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
exported as the NPY tree (``utils.plotting.export_npy``), a PNG figure per
item (``utils.plotting.export_mel_figure``: the mel above its attention;
skipped, with one warning per process, where matplotlib does not import)
and Griffin-Lim wavs (``ops.vocoder``, on the same device).

Under a launcher (``torchrun``, or ``glow-tts-torch-infer`` itself) the
ranks form the ``data × model`` grid of ``parallel/data.py``, and serving
keeps the semantics of the JAX package's data mesh
(``glow_tts_tpu/inference.py``).  ``batch_size`` is the global batch:
every rank collates the whole chunk (one token padding), a ragged chunk is
padded to a multiple of the data size with its last item repeated, and
data index d decodes rows ``[d·B/D, (d+1)·B/D)``.  The mel bucket is the
largest any data rank picks, the one a world of one picks for the chunk,
and every rank draws the noise a world of one draws for the chunk and
decodes its own rows of it, so a data-parallel decode equals a world of
one's at any ``noise_scale``.  Griffin-Lim runs on each rank's own items on
its own card.  Mels, attentions and audio are gathered over the gloo group
of host values; every rank returns the whole list in item order, and rank 0
alone writes the files.  With ``TPU.model_parallel`` above 1
(``parallel/tp.py``) each rank of a model group loads the full weights,
keeps its shard and runs its data index's rows.
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
from glow_tts_tpu_torch.parallel import data as parallel_data
from glow_tts_tpu_torch.parallel import tp
from glow_tts_tpu_torch.text import Tokenizer, load_token_dict, text_filtering
from glow_tts_tpu_torch.training.checkpoint import SNAPSHOT, CheckpointManager
from glow_tts_tpu_torch.utils.plotting import export_mel_figure, export_npy
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
    version.  The model serves at ``config.serve_dtype`` (``inference_dtype
    or compute_dtype``), from float32 weights whatever the dtype.
    ``world`` (default: the launched world, ``parallel.data.initialize``,
    where a launcher set one, else a world of one) splits each batch over
    its data groups and shards the model over its model group, which then
    serve on the world's device; its rank 0 writes the results (module
    docstring)."""

    def __init__(self, weights: Union[str, os.PathLike, Mapping],
                 config=None, device: Union[str, torch.device] = 'cuda',
                 batch_size: Optional[int] = None,
                 max_mel_length: int = 1024,
                 mel_buckets: Optional[Sequence[int]] = None,
                 step: int = 0, world=None):
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
        if world is None:
            world = (parallel_data.initialize(config, self.device)
                     if parallel_data.launched() else parallel_data.SINGLE)
        if world.size > 1:
            self.device = world.device
        self.world = world
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
        # at the serving dtype: inference_dtype, else compute_dtype
        self.model = load_state_dict(GlowTTS(config, config.serve_dtype),
                                     weights)
        tp.shard_model(self.model.to(self.device), world).prepare()

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
        each also written under ``out_dir`` if given, as the NPY tree and
        ``<out_dir>/PNG/<label>.png`` (titled with the text);
        with ``out_dir`` and ``export_wav``, the Griffin-Lim waveform
        (``griffin_lim_iterations`` on the device, the start phase from
        seed 0) in ``result['audio']`` and ``<out_dir>/WAV/<label>.wav``.
        Batch ``start`` draws its noise from a generator seeded with
        ``seed + start``.  The conditioned modes' items carry their
        ``speaker_id`` and reference features or wavs (module
        docstring).  Over a data axis each rank decodes its share of every
        batch and returns the gathered whole (module docstring)."""
        world = self.world
        results = []
        for start in range(0, len(items), self.batch_size):
            chunk = list(items[start:start + self.batch_size])
            n = len(chunk)
            # the chunk padded to a multiple of the data size with its
            # last item; this data index's rows of it
            share = -(-n // world.data_size)
            rows = [min(j, n - 1) for j in range(
                world.data_index * share, (world.data_index + 1) * share)]
            batch = self.rows_of(self.batch(chunk), n, rows)
            prior = self.model.inference_prior(
                batch['tokens'], batch['token_lengths'],
                batch['length_scales'], batch.get('mels_for_prosody'),
                batch.get('mel_lengths_for_prosody'), batch.get('speakers'),
                batch.get('mels_for_ge2e'))
            # the bucket of the longest utterance on any data rank
            bucket = world.host_max(self.pick_bucket(prior['durations']))[0]
            # the noise a world of one draws for the chunk, this rank's rows
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed + start)
            noise = torch.randn((n, bucket, self.config.sound.mel_dim),
                                generator=generator, device=self.device)
            out = self.model.inference_decode(
                prior, noise=noise[rows], noise_scale=noise_scale,
                max_mel_length=bucket, pitches=batch.get('pitches'),
                pitch_lengths=batch.get('pitch_lengths'))
            mels = out['mels'].cpu().numpy()
            mel_lengths = out['mel_lengths'].cpu().numpy()
            attentions = out['attentions'].cpu().numpy()
            token_lengths = batch['token_lengths'].cpu().numpy()
            own = []
            for i, j in enumerate(range(world.data_index * share,
                                        min((world.data_index + 1) * share,
                                            n))):
                n_mel, n_tok = int(mel_lengths[i]), int(token_lengths[i])
                item = chunk[j]
                result = {
                    'label': item.get('label', str(start + j)),
                    'text': item['text'],
                    'mel': mels[i, :n_mel],
                    'attention': attentions[i, :n_tok, :n_mel],
                    'bucket': bucket,
                }
                if export_wav and out_dir:
                    result['audio'] = vocoder.mel_to_audio(
                        result['mel'], self.config.sound,
                        griffin_lim_iterations, device=self.device)
                own.append(result)
            # every data index's results in item order (a model group's
            # ranks computed the same)
            chunk_results = ([r for part in world.gather_data(own)
                              for r in part]
                             if world.data_size > 1 else own)
            results.extend(chunk_results)
            if out_dir and world.is_main:
                for result in chunk_results:
                    self.write(out_dir, result)
        return results

    @staticmethod
    def rows_of(batch: Mapping[str, torch.Tensor], n: int,
                rows: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The rows of items ``rows`` of a batch of ``n`` items (every
        entry holds the same number of rows per item: one, or the GE2E
        slices of ``mels_for_ge2e``); all of it where ``rows`` are all."""
        if list(rows) == list(range(n)):
            return dict(batch)
        out = {}
        for key, value in batch.items():
            per = value.shape[0] // n
            index = torch.tensor([j * per + r for j in rows
                                  for r in range(per)], device=value.device)
            out[key] = value.index_select(0, index)
        return out

    def write(self, out_dir: str, result: Mapping) -> None:
        """One result's files under ``out_dir``: the PNG figure, the NPY
        tree and, where it carries audio, the wav."""
        label = result['label']
        export_mel_figure(os.path.join(out_dir, 'PNG', f'{label}.png'),
                          result['mel'], result['attention'],
                          title=result['text'])
        export_npy(out_dir, label, result['mel'], result['attention'])
        if 'audio' in result:
            vocoder.save_wav(os.path.join(out_dir, 'WAV', f'{label}.wav'),
                             result['audio'], self.config.sound.sample_rate)

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
