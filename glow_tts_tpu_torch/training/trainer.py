"""The training loop (port of ``glow_tts_tpu/training/trainer.py``, in
the four modes), in one process or one process per card (data
parallelism, ``parallel/data.py``).

``Trainer`` builds the pattern datasets, a from-scratch model whose
ActNorm is initialised on the first unshuffled batch (with its
conditioning), in GE2E mode the pre-trained speaker encoder from
``Speaker_Embedding.GE2E.Checkpoint_Path`` when it is set and no checkpoint
is restored, the optimiser (the GE2E encoder frozen) and the encoder's
dropout generator, restores a checkpoint if there is one,
and runs the train step with checkpoints, scalar logs, evaluations (with
their images and parameter histograms), inference (with a PNG figure per
sentence) and, in PE and GR modes, the prosody check at their intervals,
and with ``train(profile_steps=(a, b))`` a ``torch.profiler`` trace of
steps ``a`` to ``b``.  A resumed run repeats the uninterrupted
one (on the card with cuDNN deterministic, which ``Trainer`` sets): the
checkpoint holds the weights, the optimiser's count and moments
(the flow's dropout masks and the learning rate follow the count), the
run's seed and the generator's state, and the epoch and the batches
already consumed in it follow from the step, as the JAX trainer derives
them.  SIGTERM and Ctrl-C stop the loop between two steps and save the
step reached.  The alignment curriculum (``Train.Alignment_Warmup_Steps``
with its mode, ``Train.Decoder_Freeze_Steps``) builds one step function per
variant it needs and picks one per step, as the JAX trainer does; the 'em'
warmup's table statistics are the trainer's (``self.em``) and ride in the
checkpoints.  The model trains, evaluates and is initialised at
``config.compute_dtype``; the evaluation's free-running decode and the
inference at the intervals serve at ``inference_dtype or compute_dtype``
from the same parameters, as the JAX trainer does; checkpoints hold the
float32 parameters whatever the dtype.  The prosody check
(:meth:`Trainer.prosody_check`) writes an embedding projector of the GST
vectors of the eval set's sampled speakers.

Under data parallelism, as the JAX trainer on a mesh: every rank
initialises ActNorm on the same unshuffled first batch of the global size
and then takes rank 0's weights, so a run starts from the single-card
weights; it trains on its stride of each epoch (``shard_index`` /
``num_shards``) at ``Train.Batch_Size / ranks``, as many batches an epoch
as the rank with the fewest; the frame counts and losses are the global
batch's; a stop signal is agreed before each step, so every rank stops
after the same one; the evaluation runs on a fixed number of whole batches
per rank; only rank 0 writes logs, checkpoints (which hold every rank's
generator state) and inference, decodes and runs the prosody check; and
each rank writes its own profiler trace.

Under tensor parallelism (``TPU.model_parallel`` M above 1,
``parallel/tp.py``) the world is a ``data × model`` grid: the model is
sharded over each model group before its ActNorm initialisation (which
then runs through the sharded stack, on the replicated stream), the
data-parallel rules above hold over the data index in place of the rank,
checkpoints hold the gathered full weights and moments (a world of one's
layout) and are sharded again on restore, and the evaluation's decode, its
histograms and the inference run on every rank of rank 0's model group,
which the sharded model needs; rank 0 writes.
"""

from __future__ import annotations

import itertools
import math
import os
import signal
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from glow_tts_tpu_torch.data.collate import (ProsodyCheckCollater,
                                             TrainCollater)
from glow_tts_tpu_torch.data.loader import DataLoader
from glow_tts_tpu_torch.data.patterns import (InferenceDataset,
                                              PatternDataset,
                                              ProsodyCheckDataset)
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import initial_state_dict
from glow_tts_tpu_torch.parallel import tp
from glow_tts_tpu_torch.parallel.data import initialize, shard_seed
from glow_tts_tpu_torch.text import Tokenizer, load_token_dict
from glow_tts_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    restore_generator,
                                                    restore_train_state,
                                                    restored_em_stats,
                                                    train_payload)
from glow_tts_tpu_torch.training.optim import (learning_rate_at,
                                               make_optimizer)
from glow_tts_tpu_torch.training.step import (EMState,
                                              attention_diagonality,
                                              batch_to_device, build_model,
                                              conditioning_inputs,
                                              init_em_stats, make_eval_step,
                                              make_train_step)
from glow_tts_tpu_torch.utils.logging import (NullWriter, StepTimer,
                                              SummaryLogger, logger)
from glow_tts_tpu_torch.weights import load_ge2e_checkpoint, load_state_dict

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
    versions.  Under a launcher (``torchrun``, or ``glow-tts-torch-train``
    starting one process per card itself) the process is one rank of a
    data-parallel run and trains on ``cuda:LOCAL_RANK``
    (``parallel.data.initialize``).
    ``writers`` maps ``'train'`` and ``'eval'`` to objects with
    ``utils.logging.NullWriter``'s methods; by default two
    ``SummaryLogger``s under ``config.log_path``; ranks other than 0 take
    ``NullWriter``s."""

    def __init__(self, config, initial_step: int = 0,
                 device: Union[str, torch.device] = 'cuda',
                 max_mel_length: int = 1024,
                 writers: Optional[Mapping[str, object]] = None):
        self.config = config
        self.world = initialize(config, device)
        self.device = self.world.device
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
        if not self.world.is_main:
            self.writers = {'train': NullWriter(), 'eval': NullWriter()}
        else:
            self.writers = dict(writers) if writers is not None else {
                'train': SummaryLogger(os.path.join(config.log_path,
                                                    'Train')),
                'eval': SummaryLogger(os.path.join(config.log_path,
                                                   'Evaluation'))}
        self.timer = StepTimer()
        self.scalar_accum: Dict[str, torch.Tensor] = {}
        # the last evaluation's free-running decode of its last batch
        self.free_running: Optional[Dict[str, torch.Tensor]] = None

    def _build_model(self, initial_step: int) -> None:
        cfg, world = self.config, self.world
        self.checkpoints = CheckpointManager(
            cfg.checkpoint_path, cfg if world.is_main else None)
        payload = self.checkpoints.restore(initial_step)
        # trains, evaluates and initialises at config.compute_dtype
        model = load_state_dict(build_model(cfg),
                                initial_state_dict(cfg, RUN_SEED))
        ge2e_path = cfg.speaker_embedding.ge2e.checkpoint_path
        if payload is None and cfg.uses_ge2e and ge2e_path:
            # a new run's pre-trained speaker encoder (a restored run has it
            # in its checkpoint)
            model.load_state_dict(load_ge2e_checkpoint(ge2e_path, cfg),
                                  strict=False)
            logger.info('Loaded the pre-trained GE2E weights from %s',
                        ge2e_path)
        # this rank's shard where the model group has more than one rank
        self.model = tp.shard_model(model.to(self.device),
                                    world).prepare(fold=False)
        # unshuffled and unsharded, of the global size: the same first
        # batch whatever the run's seed and on every rank
        loader = DataLoader(self.train_dataset, self.collater,
                            cfg.train.batch_size, shuffle=False, prefetch=0)
        init = batch_to_device(next(iter(loader)), self.device)
        self.model.data_dependent_init(init['mels'], init['mel_lengths'],
                                       **conditioning_inputs(init))
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.seed = RUN_SEED
        self.generator = torch.Generator(self.device).manual_seed(
            shard_seed(self.seed, world.data_index))
        self.step = self.epoch = 0
        self.em = EMState(init_em_stats(cfg, self.device)
                          if cfg.train.uses_em_stats else None)
        if payload is not None:
            restore_train_state(self.model, self.optimizer, payload, world)
            self.seed, self.step = payload['seed'], payload['Steps']
            self.epoch = payload['Epochs']
            restore_generator(self.generator, payload, world)
            self.em.stats = restored_em_stats(payload, cfg, self.device)
            logger.info('Restored checkpoint at step %d', self.step)
        # every rank from its data group's first rank's weights: the
        # single-card start
        for tensor in self.model.state_dict().values():
            world.broadcast_(tensor)
        # the deterministic path packs these weights at its next use, not
        # the initialised ones it may hold
        self.model.layer_Dict['Decoder'].invalidate()
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          seed=self.seed,
                                          generator=self.generator,
                                          world=world)
        # the curriculum's variants, keyed (warmup, frozen decoder), only
        # those its step counts ask for
        train = cfg.train
        mode = train.alignment_warmup_mode
        self.curriculum_steps = {
            (warm, frozen): make_train_step(
                cfg, self.model, self.optimizer, seed=self.seed,
                generator=self.generator,
                linear_alignment=warm and mode == 'linear',
                anchored_alignment=warm and mode == 'anchored',
                em_alignment=warm and mode == 'em', freeze_decoder=frozen,
                em_state=self.em, world=world)
            for warm in (True, False) for frozen in (True, False)
            if (warm or frozen)
            and (train.alignment_warmup_steps or not warm)
            and (train.decoder_freeze_steps or not frozen)}
        self.eval_step = make_eval_step(cfg, self.model, world=world)

    def step_function(self, step: int):
        """The train step that step ``step`` (0-based) runs: the
        curriculum's variant for (``step`` < the warmup's steps, ``step`` <
        the freeze's steps), or the plain step."""
        train = self.config.train
        return self.curriculum_steps.get(
            (step < train.alignment_warmup_steps,
             step < train.decoder_freeze_steps), self.train_step)

    def train_loader(self, seed: int) -> DataLoader:
        """Epoch ``seed``'s batches of this rank (its stride of the epoch,
        its share of the global batch), ``num_workers`` producer
        threads."""
        workers = max(self.config.train.num_workers, 1)
        world = self.world
        return DataLoader(self.train_dataset, self.collater,
                          self.config.train.batch_size // world.data_size,
                          shuffle=True, seed=seed, prefetch=2 * workers,
                          workers=workers, shard_index=world.data_index,
                          num_shards=world.data_size)

    def save_checkpoint(self) -> Optional[str]:
        """Save the step reached (rank 0 writes; every rank takes part)."""
        payload = train_payload(self.model, self.optimizer, self.step,
                                self.epoch, self.seed, self.generator,
                                self.em.stats, self.world)
        if self.world.is_main:
            return self.checkpoints.save(self.step, payload)
        return None

    # ------------------------------------------------------------------

    def _start_profiler(self):
        """A started ``torch.profiler`` window of CPU and (on the card)
        CUDA activity, whose Chrome trace goes to ``<log_path>/profile/
        rank<r>.<ns>.pt.trace.json`` when it stops."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(
                os.path.join(self.config.log_path, 'profile'),
                worker_name=f'rank{self.world.rank}'))
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Wait for the device's queued work, then stop ``profiler``
        (which writes its trace)."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler.stop()
        logger.info('Profiler trace of steps up to %d written under %s',
                    self.step, os.path.join(self.config.log_path, 'profile'))

    def train(self, profile_steps: Optional[Sequence[int]] = None) -> None:
        """Train to ``Train.Max_Step``.  With ``profile_steps (a, b)`` a
        profiler window starts before step ``a`` (0-based, as ``self.step``
        counts) and stops once ``self.step`` reaches ``b``, before that
        step's checkpoint, logs and evaluation."""
        cfg, world = self.config.train, self.world
        profiler = None
        # the epoch and the batches of it already consumed follow from the
        # step: a resumed run takes the batches the uninterrupted one took;
        # every rank takes as many as the rank with the fewest
        batches_per_epoch, = world.host_min(len(self.train_loader(seed=0)))
        if not batches_per_epoch:
            raise ValueError(f'the train set holds fewer patterns than a '
                             f'batch ({len(self.train_dataset)} < '
                             f'{cfg.batch_size})')
        self.epoch, skip_batches = divmod(self.step, batches_per_epoch)

        # SIGTERM and Ctrl-C stop the run between two steps, where the
        # weights, the optimiser and ``self.step`` agree, and every rank
        # after the same step; a second signal stops this process at once
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
                if cfg.initial_inference and world.data_index == 0 and \
                        cfg.inference_pattern_file_in_train:
                    self.run_inference_file(
                        cfg.inference_pattern_file_in_train)
            while self.step < cfg.max_step:
                for bi, batch in enumerate(itertools.islice(
                        self.train_loader(self.epoch), batches_per_epoch)):
                    if bi < skip_batches:
                        continue
                    stopping, frames = world.host_sum(
                        len(stop), int(batch['mel_lengths'].sum()))
                    # a model group's ranks share one batch
                    frames //= world.model_size
                    if stopping:
                        raise KeyboardInterrupt(
                            stop[0] if stop else 'stopped by another rank')
                    if profile_steps and self.step == profile_steps[0]:
                        profiler = self._start_profiler()
                    metrics = self.step_function(self.step)(
                        batch_to_device(batch, self.device))
                    self.step += 1
                    if profiler is not None and \
                            self.step == profile_steps[1]:
                        self._stop_profiler(profiler)
                        profiler = None
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
            if profiler is not None:    # the run ended inside the window
                self._stop_profiler(profiler)
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
                self.world.data_index == 0 \
                and cfg.inference_pattern_file_in_train:
            self.run_inference_file(cfg.inference_pattern_file_in_train)
        if self.config.uses_prosody_encoder and self.world.is_main and \
                self.step % cfg.prosody_check_interval == 0:
            self.prosody_check()

    # ------------------------------------------------------------------

    def evaluate(self) -> Dict[str, float]:
        """Mean losses and alignment diagonality over the eval set (in
        order, the last batch ragged), written to the eval writer and
        returned; then a free-running decode of the last batch with noise
        seeded from the step (``self.free_running``), and for its first
        sample the eval writer's images ``Mel/Target`` (the target mel
        transposed, cut to its length), ``Attention/From_Train`` (the eval
        step's MAS path) and ``Attention/From_Inference`` (the free-running
        path), and a histogram of every parameter.  Under data parallelism
        each rank takes its stride of the set in whole batches of its
        share, as many as every rank has (the JAX trainer's count), the
        losses of each global batch; rank 0 decodes and writes the images
        and histograms (under tensor parallelism with the rest of its
        model group, which decodes and gathers the parameters with it)."""
        world = self.world
        local_batch = self.config.train.batch_size // world.data_size
        loader = DataLoader(self.eval_dataset, self.collater, local_batch,
                            shuffle=False, prefetch=0,
                            drop_last=world.data_size > 1,
                            shard_index=world.data_index,
                            num_shards=world.data_size)
        batches = iter(loader)
        if world.data_size > 1:
            batches = itertools.islice(batches, len(self.eval_dataset)
                                       // world.data_size // local_batch)
        totals: Dict[str, torch.Tensor] = {}
        count, last, last_outputs = 0, None, None
        for batch in batches:
            batch = batch_to_device(batch, self.device)
            loss_dict, outputs = self.eval_step(batch)
            values = {f'Loss/{tag}': value for tag, value in loss_dict.items()}
            values['Alignment/diagonality'] = attention_diagonality(
                outputs['attentions'], batch['token_lengths'],
                batch['mel_lengths'], world)
            for tag, value in values.items():
                totals[tag] = totals[tag] + value if tag in totals else value
            count, last, last_outputs = count + 1, batch, outputs
        if not count:
            return {}
        means = dict(zip(totals, (torch.stack(list(totals.values()))
                                  / count).tolist()))
        self.writers['eval'].add_scalars(means, self.step)
        if world.data_index != 0:
            return means

        # the conditioned modes serve from the batch's own references: its
        # speakers and GE2E slices, its mels for the GST, its pitch tracks;
        # at the serving dtype (inference_dtype or compute_dtype), on the
        # same parameters
        generator = torch.Generator(self.device).manual_seed(self.step)
        with self.model.computing_at(self.config.serve_dtype) as model:
            prior = model.inference_prior(
                last['tokens'], last['token_lengths'],
                mels_for_prosody=last['mels'],
                mel_lengths_for_prosody=last['mel_lengths'],
                speakers=last.get('speakers'),
                mels_for_ge2e=last.get('mels_for_ge2e'))
            self.free_running = model.inference_decode(
                prior, generator=generator,
                max_mel_length=self.max_mel_length,
                pitches=last.get('pitches'),
                pitch_lengths=last['mel_lengths'])
        t_tok = int(last['token_lengths'][0])
        t_mel = int(last['mel_lengths'][0])

        def host(tensor):
            return tensor.detach().float().cpu().numpy()
        self.writers['eval'].add_images({
            'Mel/Target': host(last['mels'][0, :t_mel]).T,
            'Attention/From_Train': host(
                last_outputs['attentions'][0, :t_tok, :t_mel]),
            'Attention/From_Inference': host(
                self.free_running['attentions'][0, :t_tok])}, self.step)
        self.writers['eval'].add_histograms(
            tp.gather_state_dict(dict(self.model.named_parameters()), world,
                                 tp.specs_of(self.model)), self.step)
        return means

    def run_inference_file(self, pattern_file: str) -> List[Dict]:
        """Synthesise the TSV's sentences on the current weights into
        ``<inference_path>/Step-<step>``: the NPY tree and a PNG figure
        per sentence (``PNG/<label>.png``, where matplotlib imports)."""
        dataset = InferenceDataset(pattern_file)
        if not len(dataset):
            return []
        # the full weights, sharded again by the Inferencer over this
        # rank's model group, which serves alone (the other data indices
        # skip the inference)
        inferencer = Inferencer(tp.full_state_dict(self.model, self.world),
                                self.config, self.device,
                                max_mel_length=self.max_mel_length,
                                world=self.world.within_model_group())
        out_dir = os.path.join(self.config.inference_path,
                               f'Step-{self.step}')
        return inferencer.synthesize_items(dataset.entries, out_dir=out_dir,
                                           seed=self.step)

    def prosody_check(self) -> Optional[Tuple[np.ndarray, List[str]]]:
        """The GST vectors ``[N, P]`` (float32) of the eval pattern set's
        sampled speakers (``ProsodyCheckDataset``, its mel-length filter),
        computed in batches of ``Train.Batch_Size`` at the model's compute
        dtype without autograd, written to the eval writer as the
        embedding ``'GST'`` with the speakers as labels, and returned with
        the labels; None where the set samples nothing.  Holds no
        collective: under data parallelism the trainer runs it on rank 0
        alone."""
        pattern = self.config.train.eval_pattern
        dataset = ProsodyCheckDataset(
            pattern_path=pattern.path, metadata_file=pattern.metadata_file,
            mel_length_min=pattern.mel_length_min,
            mel_length_max=pattern.mel_length_max)
        if not len(dataset):
            return None
        loader = DataLoader(dataset, ProsodyCheckCollater(self.config),
                            self.config.train.batch_size, shuffle=False,
                            prefetch=0, drop_last=False)
        embeddings, labels = [], []
        for batch in loader:
            embeddings.append(self.model.encode_prosody(
                torch.as_tensor(batch['mels'], device=self.device),
                torch.as_tensor(batch['mel_lengths'],
                                device=self.device)).float())
            labels.extend(batch['labels'])
        embeddings = torch.cat(embeddings).cpu().numpy()
        self.writers['eval'].add_embedding(embeddings, labels, self.step,
                                           tag='GST')
        return embeddings, labels
