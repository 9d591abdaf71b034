"""The train step and the loss/eval path (port of
``glow_tts_tpu/training/step.py``, Vanilla terms): model construction, the
loss dict, the train step (forward with dropout → MAS → losses → backward
→ clip → RAdam/Noam update), the eval step and the alignment-health
metric the evaluation reports beside the losses.  The alignment-warmup
variants of the step and the decoder freeze are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from glow_tts_tpu_torch.models.decoder import FlowStackFn, FlowStepFn
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, MasFn
from glow_tts_tpu_torch.ops.coupling import coupling, flow_stack, flow_step
from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.training import losses
from glow_tts_tpu_torch.training.optim import RAdam

Batch = Mapping[str, torch.Tensor]


def build_model(config) -> GlowTTS:
    return GlowTTS(config)


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


def compute_losses(config, outputs: Mapping[str, torch.Tensor],
                   batch: Batch) -> Dict[str, torch.Tensor]:
    loss_dict = {
        'mle': losses.mle_loss(
            outputs['z'], outputs['mel_mean'], outputs['mel_log_std'],
            outputs['log_dets'], batch['mel_lengths'],
            config.decoder.num_squeeze, config.sound.mel_dim),
        'duration': losses.duration_loss(
            outputs['log_durations'], outputs['log_duration_targets']),
    }
    loss_dict['total'] = loss_dict['mle'] + loss_dict['duration']
    return loss_dict


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
                    mas_fn: MasFn = maximum_path
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``train_step(batch) -> metrics`` (``mle``, ``duration``, ``total``,
    ``grad_norm``, 0-d tensors on the model's device, read without a
    synchronisation): one update of ``model``'s parameters, in place,
    through ``optimizer`` (``training.optim.make_optimizer`` over
    ``model.parameters()``).  The model must hold unfolded weight norm
    (``prepare(fold=False)``).

    Dropout is explicit: the encoder's masks come from ``generator`` (on
    the model's device; one seeded with ``seed`` is made if none is given)
    and the flow's from ``flow_seed(seed, step)``.  The same weights, seed
    and generator state give the same step.  ``stack_fn`` and ``mas_fn``
    are the kernels' wrappers unless a caller compares them with their
    plain versions."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        outputs = model(batch['tokens'], batch['token_lengths'],
                        batch['mels'], batch['mel_lengths'], mas_fn=mas_fn,
                        deterministic=False,
                        seed=flow_seed(seed, optimizer.count),
                        generator=generator, stack_fn=stack_fn)
        loss_dict = compute_losses(config, outputs, batch)
        loss_dict['total'].backward()
        grad_norm = optimizer.step()
        # the deterministic path packs the new weights at its next use
        model.layer_Dict['Decoder'].invalidate()
        metrics = {key: value.detach() for key, value in loss_dict.items()}
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step


def make_eval_step(config, model: GlowTTS, step_fn: FlowStepFn = flow_step,
                   mas_fn: MasFn = maximum_path,
                   coupling_fn: FlowStepFn = coupling,
                   flow_stack_fn: FlowStepFn = flow_stack
                   ) -> Callable[[Batch], Tuple[Dict, Dict]]:
    """``eval_step(batch) -> (loss_dict, outputs)`` on the model's current
    weights, without gradients; the flow takes the route of the model's
    ``coupling_backend``.  ``step_fn``, ``coupling_fn``, ``flow_stack_fn``
    and ``mas_fn`` are the kernels' wrappers unless a caller compares them
    with their plain versions."""

    @torch.no_grad()
    def eval_step(batch: Batch):
        outputs = model(batch['tokens'], batch['token_lengths'],
                        batch['mels'], batch['mel_lengths'],
                        step_fn=step_fn, mas_fn=mas_fn,
                        coupling_fn=coupling_fn, flow_stack_fn=flow_stack_fn)
        return compute_losses(config, outputs, batch), outputs

    return eval_step


def attention_diagonality(attentions: torch.Tensor,
                          token_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor) -> torch.Tensor:
    """Mean closeness of the MAS paths ``[B, T_tok, T_mel]`` to the ideal
    diagonal, computed where the attention lives; 1.0 is a perfectly linear
    alignment.  Samples shorter than 2 tokens or 2 frames do not count."""
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
    return torch.sum(score * ok) / torch.sum(ok).clamp_min(1)
