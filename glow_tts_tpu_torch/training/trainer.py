"""The training loop (port of ``glow_tts_tpu/training/trainer.py``,
one process, Vanilla mode).

``Trainer`` builds the pattern datasets, a from-scratch model whose
ActNorm is initialised on the first unshuffled batch, the optimiser and
the encoder's dropout generator, restores a checkpoint if there is one,
and runs the train step with checkpoints, scalar logs, evaluations and
inference at their intervals.  A resumed run repeats the uninterrupted
one (on the card with cuDNN deterministic, which ``Trainer`` sets): the
checkpoint holds the weights, the optimiser's count and moments
(the flow's dropout masks and the learning rate follow the count), the
run's seed and the generator's state, and the epoch and the batches
already consumed in it follow from the step, as the JAX trainer derives
them.  SIGTERM and Ctrl-C stop the loop between two steps and save the
step reached.
"""

from __future__ import annotations

import math
import os
import signal
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from glow_tts_tpu_torch.data.collate import TrainCollater
from glow_tts_tpu_torch.data.loader import DataLoader
from glow_tts_tpu_torch.data.patterns import InferenceDataset, PatternDataset
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, initial_state_dict
from glow_tts_tpu_torch.text import Tokenizer, load_token_dict
from glow_tts_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    train_payload)
from glow_tts_tpu_torch.training.optim import (learning_rate_at,
                                               make_optimizer)
from glow_tts_tpu_torch.training.step import (attention_diagonality,
                                              batch_to_device,
                                              make_eval_step,
                                              make_train_step)
from glow_tts_tpu_torch.utils.logging import StepTimer, SummaryLogger, logger
from glow_tts_tpu_torch.weights import load_state_dict

# the seed of a new run's weights, dropout streams and generator (the JAX
# trainer's ``PRNGKey(0)``); a resumed run takes its checkpoint's
RUN_SEED = 0


def pattern_dataset(pattern, use_cache: bool) -> PatternDataset:
    """The dataset of a ``PatternConfig``."""
    return PatternDataset(
        pattern_path=pattern.path, metadata_file=pattern.metadata_file,
        accumulated_dataset_epoch=pattern.accumulated_dataset_epoch,
        mel_length_min=pattern.mel_length_min,
        mel_length_max=pattern.mel_length_max,
        text_length_min=pattern.text_length_min,
        text_length_max=pattern.text_length_max, use_cache=use_cache)


class Trainer:
    """``device`` is where the model trains: ``'cuda'`` (the default)
    through the kernels, raising where CUDA is absent, with cuDNN set
    deterministic for the whole process; ``'cpu'`` through their plain
    versions.  ``writers`` maps ``'train'`` and ``'eval'`` to
    objects with ``utils.logging.NullWriter``'s methods; by default two
    ``SummaryLogger``s under ``config.log_path``."""

    def __init__(self, config, initial_step: int = 0,
                 device: Union[str, torch.device] = 'cuda',
                 max_mel_length: int = 1024,
                 writers: Optional[Mapping[str, object]] = None):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {self.device} requested but CUDA '
                               f'is not available')
        if self.device.type == 'cuda':
            # the encoder's convolutions backward by fixed algorithms, so
            # that a resumed run repeats the uninterrupted one on the card
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.max_mel_length = max_mel_length
        token_dict = None
        if config.token_path and os.path.exists(config.token_path):
            token_dict = load_token_dict(config.token_path)
        self.collater = TrainCollater(config, Tokenizer(token_dict))

        use_cache = config.train.use_pattern_cache
        self.train_dataset = pattern_dataset(config.train.train_pattern,
                                             use_cache)
        self.eval_dataset = pattern_dataset(config.train.eval_pattern,
                                            use_cache)
        self._build_model(initial_step)
        self.writers = dict(writers) if writers is not None else {
            'train': SummaryLogger(os.path.join(config.log_path, 'Train')),
            'eval': SummaryLogger(os.path.join(config.log_path,
                                               'Evaluation'))}
        self.timer = StepTimer()
        self.scalar_accum: Dict[str, torch.Tensor] = {}
        # the last evaluation's free-running decode of its last batch
        self.free_running: Optional[Dict[str, torch.Tensor]] = None

    def _build_model(self, initial_step: int) -> None:
        cfg = self.config
        self.model = load_state_dict(
            GlowTTS(cfg), initial_state_dict(cfg, RUN_SEED)
        ).to(self.device).prepare(fold=False)
        # unshuffled: the same first batch whatever the run's seed
        loader = DataLoader(self.train_dataset, self.collater,
                            cfg.train.batch_size, shuffle=False, prefetch=0)
        init = batch_to_device(next(iter(loader)), self.device)
        self.model.data_dependent_init(init['mels'], init['mel_lengths'])
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.seed = RUN_SEED
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.step = self.epoch = 0

        self.checkpoints = CheckpointManager(cfg.checkpoint_path, cfg)
        payload = self.checkpoints.restore(initial_step)
        if payload is not None:
            load_state_dict(self.model, payload['Model'])
            # the deterministic path packs the restored weights at its
            # next use, not the initialised ones it may hold
            self.model.layer_Dict['Decoder'].invalidate()
            self.optimizer.load_state_dict(payload['Optimizer'], self.model)
            self.generator.set_state(payload['generator'])
            self.seed, self.step = payload['seed'], payload['Steps']
            self.epoch = payload['Epochs']
            logger.info('Restored checkpoint at step %d', self.step)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          seed=self.seed,
                                          generator=self.generator)
        self.eval_step = make_eval_step(cfg, self.model)

    def train_loader(self, seed: int) -> DataLoader:
        """Epoch ``seed``'s batches, ``num_workers`` producer threads."""
        workers = max(self.config.train.num_workers, 1)
        return DataLoader(self.train_dataset, self.collater,
                          self.config.train.batch_size, shuffle=True,
                          seed=seed, prefetch=2 * workers, workers=workers)

    def save_checkpoint(self) -> str:
        return self.checkpoints.save(self.step, train_payload(
            self.model, self.optimizer, self.step, self.epoch, self.seed,
            self.generator))

    # ------------------------------------------------------------------

    def train(self) -> None:
        cfg = self.config.train
        # the epoch and the batches of it already consumed follow from the
        # step: a resumed run takes the batches the uninterrupted one took
        batches_per_epoch = len(self.train_loader(seed=0))
        if not batches_per_epoch:
            raise ValueError(f'the train set holds fewer patterns than a '
                             f'batch ({len(self.train_dataset)} < '
                             f'{cfg.batch_size})')
        self.epoch, skip_batches = divmod(self.step, batches_per_epoch)

        # SIGTERM and Ctrl-C stop the run between two steps, where the
        # weights, the optimiser and ``self.step`` agree; a second signal
        # stops it at once
        stop = []

        def on_signal(signum, frame):
            if stop:
                raise KeyboardInterrupt(signal.Signals(signum).name)
            stop.append(signal.Signals(signum).name)

        handlers = {signum: signal.signal(signum, on_signal)
                    for signum in (signal.SIGTERM, signal.SIGINT)}
        try:
            if self.step == 0:
                self.evaluate()
                if cfg.initial_inference and \
                        cfg.inference_pattern_file_in_train:
                    self.run_inference_file(
                        cfg.inference_pattern_file_in_train)
            while self.step < cfg.max_step:
                for bi, batch in enumerate(self.train_loader(self.epoch)):
                    if bi < skip_batches:
                        continue
                    if stop:
                        raise KeyboardInterrupt(stop[0])
                    frames = int(batch['mel_lengths'].sum())
                    metrics = self.train_step(
                        batch_to_device(batch, self.device))
                    self.step += 1
                    self._after_step(metrics, frames)
                    if self.step >= cfg.max_step:
                        break
                else:
                    skip_batches = 0
                    self.epoch += 1
        except KeyboardInterrupt:
            if self.optimizer.count == self.step:
                logger.info('Interrupted: saving a checkpoint at step %d',
                            self.step)
                self.save_checkpoint()
            else:               # stopped inside an update: nothing to save
                logger.warning('Interrupted inside step %d: the last '
                               'checkpoint stands', self.step + 1)
            raise
        finally:
            for signum, handler in handlers.items():
                signal.signal(signum, handler)
        self.save_checkpoint()

    def _after_step(self, metrics: Mapping[str, torch.Tensor],
                    frames: int) -> None:
        cfg = self.config.train
        self.timer.add_frames(frames)
        # summed on the device, read once per logging interval
        for tag, value in metrics.items():
            key = f'Loss/{tag}'
            self.scalar_accum[key] = (self.scalar_accum[key] + value
                                      if key in self.scalar_accum else value)

        if self.step % cfg.checkpoint_save_interval == 0:
            self.save_checkpoint()
        if self.step % cfg.logging_interval == 0:
            values = torch.stack(list(self.scalar_accum.values())).tolist()
            scalars = {tag: value / cfg.logging_interval
                       for tag, value in zip(self.scalar_accum, values)}
            if not math.isfinite(scalars.get('Loss/total', 0.0)):
                logger.error('Non-finite loss around step %d: stopping; the '
                             'last checkpoint is in %s', self.step,
                             self.checkpoints.directory)
                raise FloatingPointError(
                    f'non-finite training loss at step {self.step}')
            scalars['Learning_Rate'] = learning_rate_at(self.config,
                                                        self.step)
            scalars.update(self.timer.tick(cfg.logging_interval))
            self.writers['train'].add_scalars(scalars, self.step)
            self.scalar_accum = {}
        if self.step % cfg.evaluation_interval == 0:
            self.evaluate()
        if self.step % cfg.inference_interval == 0 and \
                cfg.inference_pattern_file_in_train:
            self.run_inference_file(cfg.inference_pattern_file_in_train)

    # ------------------------------------------------------------------

    def evaluate(self) -> Dict[str, float]:
        """Mean losses and alignment diagonality over the eval set (in
        order, the last batch ragged), written to the eval writer and
        returned; then a free-running decode of the last batch with noise
        seeded from the step (``self.free_running``)."""
        loader = DataLoader(self.eval_dataset, self.collater,
                            self.config.train.batch_size, shuffle=False,
                            prefetch=0, drop_last=False)
        totals: Dict[str, torch.Tensor] = {}
        count, last = 0, None
        for batch in loader:
            batch = batch_to_device(batch, self.device)
            loss_dict, outputs = self.eval_step(batch)
            values = {f'Loss/{tag}': value for tag, value in loss_dict.items()}
            values['Alignment/diagonality'] = attention_diagonality(
                outputs['attentions'], batch['token_lengths'],
                batch['mel_lengths'])
            for tag, value in values.items():
                totals[tag] = totals[tag] + value if tag in totals else value
            count, last = count + 1, batch
        if not count:
            return {}
        means = dict(zip(totals, (torch.stack(list(totals.values()))
                                  / count).tolist()))
        self.writers['eval'].add_scalars(means, self.step)

        generator = torch.Generator(self.device).manual_seed(self.step)
        prior = self.model.inference_prior(last['tokens'],
                                           last['token_lengths'])
        self.free_running = self.model.inference_decode(
            prior, generator=generator, max_mel_length=self.max_mel_length)
        return means

    def run_inference_file(self, pattern_file: str) -> List[Dict]:
        """Synthesise the TSV's sentences on the current weights into
        ``<inference_path>/Step-<step>/NPY``."""
        dataset = InferenceDataset(pattern_file)
        if not len(dataset):
            return []
        inferencer = Inferencer(self.model.state_dict(), self.config,
                                self.device,
                                max_mel_length=self.max_mel_length)
        out_dir = os.path.join(self.config.inference_path,
                               f'Step-{self.step}')
        return inferencer.synthesize_items(dataset.entries, out_dir=out_dir,
                                           seed=self.step)
