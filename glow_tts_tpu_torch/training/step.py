"""The train step and the loss/eval path (port of
``glow_tts_tpu/training/step.py``) in the four modes: model construction,
the loss dict (GR mode adds the speaker classifier's term), the train step
(forward with dropout → MAS → losses → backward → clip → RAdam/Noam
update), its alignment-curriculum variants (the 'linear', 'anchored' and
'em' warmup paths and the decoder freeze, one step function each, which the
trainer picks per step), the eval step and the alignment-health metric the
evaluation reports beside the losses.  The steps compute at the model's
dtype (:func:`build_model`: ``config.compute_dtype``); the losses are
float32 and, the parameters being float32, so are the gradients, so the
optimiser, its clipping and its schedule are those of a float32 run and
no gradient scaler is needed.

Under data parallelism (a :class:`~glow_tts_tpu_torch.parallel.data.World`
of more than one rank) each rank steps on its share of the global batch:
its losses are its share of the global batch's, whose counts are agreed
before the forward (:func:`loss_denominators`; ``training/losses.py``),
the 'em' table's statistics are summed over the ranks, the gradients are
summed over them before the update (so the clip norm reads the same
gradients on every rank), and the reported metrics are the global
batch's.  Rank r's flow dropout is the JAX package's shard r's, and its
encoder dropout a stream of its own.

Under tensor parallelism (``parallel/tp.py``) the ranks of a model group
hold one model between them and step on the same share: every reduction
above runs over the data group alone, the seeds and the encoder's
generator follow the data index, so the ranks of a model group draw the
same masks, and no gradient is summed over the model group (the
collectives' backward passes already give every rank the whole gradient
of a replicated parameter).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from glow_tts_tpu_torch.models.decoder import FlowStackFn, FlowStepFn
from glow_tts_tpu_torch.models.glow_tts import EMStats, GlowTTS, MasFn
from glow_tts_tpu_torch.ops.coupling import coupling, flow_stack, flow_step
from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.parallel.data import SINGLE, World, shard_seed
from glow_tts_tpu_torch.training import losses
from glow_tts_tpu_torch.training.optim import RAdam

Batch = Mapping[str, torch.Tensor]


def build_model(config) -> GlowTTS:
    """The model at ``config.compute_dtype``, as the JAX package builds
    it (``glow_tts_tpu/training/step.py::build_model``): its train step,
    eval step and ActNorm initialisation compute at that dtype, on float32
    parameters."""
    return GlowTTS(config, config.compute_dtype)


def init_em_stats(config, device: Union[str, torch.device] = 'cpu'
                  ) -> EMStats:
    """Zero table statistics of the 'em' warmup, ``(cnt [V], s0 [V, M],
    s1 [V, M])`` in float32 on ``device`` (z is unsqueezed back to the mel
    channels)."""
    vocab = config.encoder.embedding_tokens
    channels = config.sound.mel_dim
    return (torch.zeros((vocab,), device=device),
            torch.zeros((vocab, channels), device=device),
            torch.zeros((vocab, channels), device=device))


class EMState:
    """The holder of a run's 'em' warmup statistics (``stats``: ``(cnt,
    s0, s1)`` or None outside that mode): an EM step reads them and
    replaces them with the updated ones, the trainer owns the holder and
    its checkpoints save what it holds."""

    def __init__(self, stats: Optional[EMStats] = None):
        self.stats = stats


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``, copied on the
    calling thread.  To a card from pinned memory on the current stream,
    which the host does not wait for: the caching host allocator keeps a
    pinned buffer until its copy is done.  ``chip_smoke.py::time_fed_loop``
    times this copy against a pageable one."""
    if torch.device(device).type != 'cuda':
        return {key: torch.as_tensor(value, device=device)
                for key, value in batch.items()}
    return {key: torch.as_tensor(value).pin_memory().to(device,
                                                        non_blocking=True)
            for key, value in batch.items()}


@dataclasses.dataclass(frozen=True)
class LossDenominators:
    """The global batch's counts that the losses divide by
    (``training/losses.py``): its valid flow frames and valid tokens (on
    the batch's device), its size, its longest padded token axis, and
    whether this rank adds the MLE's constant (rank 0)."""

    frames: torch.Tensor
    tokens: torch.Tensor
    batch: int
    token_axis: int
    main: bool = True


def loss_denominators(config, batch: Batch, world: World = SINGLE
                      ) -> LossDenominators:
    """The counts of the global batch whose share under ``world`` is
    ``batch``, agreed over the ranks before the forward: one device sum
    of the valid frames and tokens, one host max of the padded token
    axis; nothing to agree in a world of one."""
    token_axis, = world.host_max(batch['tokens'].shape[1])
    frames = torch.sum(torch.div(batch['mel_lengths'],
                                 config.decoder.num_squeeze,
                                 rounding_mode='floor'))
    frames, tokens = world.all_sum(torch.stack(
        [frames, torch.sum(batch['token_lengths'])])).unbind()
    return LossDenominators(frames, tokens,
                            batch['tokens'].shape[0] * world.data_size,
                            token_axis, world.data_index == 0)


def compute_losses(config, outputs: Mapping[str, torch.Tensor],
                   batch: Batch,
                   denominators: Optional[LossDenominators] = None
                   ) -> Dict[str, torch.Tensor]:
    """The loss dict of one batch; with the global batch's
    ``denominators`` (:func:`loss_denominators`) this rank's share of the
    global batch's (the ranks' dicts sum to it), by default ``batch``'s
    own."""
    den = denominators or loss_denominators(config, batch)
    loss_dict = {
        'mle': losses.mle_loss(
            outputs['z'], outputs['mel_mean'], outputs['mel_log_std'],
            outputs['log_dets'], batch['mel_lengths'],
            config.decoder.num_squeeze, config.sound.mel_dim,
            frames=den.frames, constant=den.main),
        'duration': losses.duration_loss(
            outputs['log_durations'], outputs['log_duration_targets'],
            batch=den.batch, token_axis=den.token_axis),
    }
    total = loss_dict['mle'] + loss_dict['duration']
    if outputs.get('classified_speakers') is not None:
        loss_dict['speaker'] = losses.speaker_ce_loss(
            outputs['classified_speakers'], batch['speakers'],
            batch=den.batch)
        total = total + loss_dict['speaker']
    if outputs.get('distill_mean') is not None:
        # the 'em' warmup: the network prior regressed onto the EM table
        loss_dict['distill'] = losses.prior_distill_loss(
            outputs['prior_mean'], outputs['prior_log_std'],
            outputs['distill_mean'], outputs['distill_log_std'],
            outputs['token_mask'], tokens=den.tokens)
        total = total + config.train.em_distill_weight * loss_dict['distill']
    loss_dict['total'] = total
    return loss_dict


def global_metrics(loss_dict: Mapping[str, torch.Tensor],
                   world: World = SINGLE) -> Dict[str, torch.Tensor]:
    """The ranks' loss dicts summed (one collective), detached: the global
    batch's losses."""
    values = world.all_sum(torch.stack([v.detach() for v in
                                        loss_dict.values()]))
    return dict(zip(loss_dict, values.unbind()))


def conditioning_inputs(batch: Batch) -> Dict[str, torch.Tensor]:
    """The batch's conditioning fields (``speakers``, ``mels_for_ge2e``,
    ``pitches``) that it has, as ``GlowTTS.forward`` takes them."""
    return {key: batch[key] for key in ('speakers', 'mels_for_ge2e',
                                        'pitches') if key in batch}


def flow_seed(seed: int, step: int) -> int:
    """The int32 seed of the flow's dropout masks at train step ``step``:
    the run's seed with the step counter folded in, so every step draws
    other masks and a resumed run draws the same ones."""
    mixed = (int(seed) + (int(step) + 1) * 0x9E3779B9) & 0xFFFFFFFF
    return mixed - (1 << 32) if mixed >= (1 << 31) else mixed


def make_train_step(config, model: GlowTTS, optimizer: RAdam, *,
                    seed: int = 0,
                    generator: Optional[torch.Generator] = None,
                    stack_fn: FlowStackFn = flow_stack_train,
                    mas_fn: MasFn = maximum_path,
                    linear_alignment: bool = False,
                    anchored_alignment: bool = False,
                    em_alignment: bool = False,
                    freeze_decoder: bool = False,
                    em_state: Optional[EMState] = None,
                    world: World = SINGLE
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``train_step(batch) -> metrics`` (``mle``, ``duration``, in GR mode
    ``speaker``, with ``em_alignment`` ``distill``, ``total``,
    ``grad_norm``, 0-d tensors on the model's device, read without a
    synchronisation): one update of ``model``'s parameters, in place,
    through ``optimizer`` (``training.optim.make_optimizer`` over
    ``model.parameters()``).  The model must hold unfolded weight norm
    (``prepare(fold=False)``).

    The alignment curriculum's variants: ``linear_alignment``,
    ``anchored_alignment`` and ``em_alignment`` take the path from that
    warmup (``GlowTTS.forward``); ``em_alignment`` reads the statistics
    of ``em_state`` and replaces them with the updated ones.
    ``freeze_decoder`` gives the flow decoder's parameters a zero update
    while their gradients still move the optimiser's moments
    (``RAdam.step``'s ``frozen``).

    Dropout is explicit: the encoder's masks come from ``generator`` (on
    the model's device; one seeded with ``shard_seed(seed, data_index)``
    is made if none is given) and the flow's from ``shard_seed(flow_seed(
    seed, step), data_index)``, the JAX package's shard ``data_index``'s
    masks.  The same
    weights, seed and generator state give the same step.  ``stack_fn``
    and ``mas_fn`` are the kernels' wrappers unless a caller compares them
    with their plain versions.

    ``world`` is the run's world (``parallel/data.py``): the batch is
    this rank's data group's share of the global batch, and the step
    reduces what the global batch needs (module docstring); a world of
    one reduces nothing."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(
            shard_seed(seed, world.data_index))
    if em_alignment and (em_state is None or em_state.stats is None):
        raise ValueError('an em_alignment step needs an EMState holding '
                         'the statistics (init_em_stats)')
    frozen = (list(model.layer_Dict['Decoder'].parameters())
              if freeze_decoder else [])

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        # cuDNN's recurrent layers (the GST's GRU) keep what their backward
        # reads only in training mode; no other module reads the mode
        model.train()
        denominators = loss_denominators(config, batch, world)
        outputs = model(batch['tokens'], batch['token_lengths'],
                        batch['mels'], batch['mel_lengths'], mas_fn=mas_fn,
                        deterministic=False,
                        seed=shard_seed(flow_seed(seed, optimizer.count),
                                        world.data_index),
                        generator=generator, stack_fn=stack_fn,
                        linear_alignment=linear_alignment,
                        anchored_alignment=anchored_alignment,
                        em_alignment=em_alignment,
                        em_stats=em_state.stats if em_alignment else None,
                        em_reduce=world.all_sum_each,
                        **conditioning_inputs(batch))
        loss_dict = compute_losses(config, outputs, batch, denominators)
        loss_dict['total'].backward()
        world.reduce_gradients(optimizer.params)
        grad_norm = optimizer.step(frozen)
        if em_alignment:
            em_state.stats = outputs['em_stats']
        # the deterministic path packs the new weights at its next use
        model.layer_Dict['Decoder'].invalidate()
        metrics = global_metrics(loss_dict, world)
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step


def make_eval_step(config, model: GlowTTS, step_fn: FlowStepFn = flow_step,
                   mas_fn: MasFn = maximum_path,
                   coupling_fn: FlowStepFn = coupling,
                   flow_stack_fn: FlowStepFn = flow_stack,
                   world: World = SINGLE
                   ) -> Callable[[Batch], Tuple[Dict, Dict]]:
    """``eval_step(batch) -> (loss_dict, outputs)`` on the model's current
    weights, without gradients; the flow takes the route of the model's
    ``coupling_backend``.  ``step_fn``, ``coupling_fn``, ``flow_stack_fn``
    and ``mas_fn`` are the kernels' wrappers unless a caller compares them
    with their plain versions.  Under data parallelism (``world``) the
    batch is this rank's share and the losses are the global batch's,
    the same on every rank; ``outputs`` are this rank's."""

    @torch.no_grad()
    def eval_step(batch: Batch):
        denominators = loss_denominators(config, batch, world)
        outputs = model(batch['tokens'], batch['token_lengths'],
                        batch['mels'], batch['mel_lengths'],
                        step_fn=step_fn, mas_fn=mas_fn,
                        coupling_fn=coupling_fn, flow_stack_fn=flow_stack_fn,
                        **conditioning_inputs(batch))
        return global_metrics(compute_losses(config, outputs, batch,
                                             denominators), world), outputs

    return eval_step


def attention_diagonality(attentions: torch.Tensor,
                          token_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor,
                          world: World = SINGLE) -> torch.Tensor:
    """Mean closeness of the MAS paths ``[B, T_tok, T_mel]`` to the ideal
    diagonal, computed where the attention lives; 1.0 is a perfectly linear
    alignment.  Samples shorter than 2 tokens or 2 frames do not count.
    Under data parallelism the mean over the global batch's samples."""
    t_mel = attentions.shape[2]
    tx = token_lengths.float()
    ty = mel_lengths.float()
    idx = torch.argmax(attentions, dim=1).float()            # [B, T_mel]
    frames = torch.arange(t_mel, device=attentions.device,
                          dtype=torch.float32)[None, :]
    ideal = frames * (tx[:, None] - 1.0) / (ty[:, None] - 1.0).clamp_min(1.0)
    valid = frames < ty[:, None]
    err = torch.sum(torch.abs(idx - ideal) * valid, dim=1) / ty.clamp_min(1.0)
    score = 1.0 - err / tx.clamp_min(1.0)
    ok = (token_lengths >= 2) & (mel_lengths >= 2)
    total, count = world.all_sum(torch.stack(
        [torch.sum(score * ok), torch.sum(ok).float()])).unbind()
    return total / count.clamp_min(1)
