"""The loss and eval path (port of ``glow_tts_tpu/training/step.py``,
Vanilla terms): model construction, the loss dict, the eval step and the
alignment-health metric the evaluation reports beside the losses.  The
train step (gradients, optimiser, dropout) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from glow_tts_tpu_torch.models.decoder import FlowStepFn
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, MasFn
from glow_tts_tpu_torch.ops.coupling import flow_step
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.training import losses

Batch = Mapping[str, torch.Tensor]


def build_model(config) -> GlowTTS:
    return GlowTTS(config)


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``."""
    return {key: torch.as_tensor(value, device=device)
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


def make_eval_step(config, model: GlowTTS, step_fn: FlowStepFn = flow_step,
                   mas_fn: MasFn = maximum_path
                   ) -> Callable[[Batch], Tuple[Dict, Dict]]:
    """``eval_step(batch) -> (loss_dict, outputs)`` on the model's current
    weights, without gradients.  ``step_fn`` and ``mas_fn`` are the
    kernels' wrappers unless a caller compares them with their plain
    versions."""

    @torch.no_grad()
    def eval_step(batch: Batch):
        outputs = model(batch['tokens'], batch['token_lengths'],
                        batch['mels'], batch['mel_lengths'],
                        step_fn=step_fn, mas_fn=mas_fn)
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
