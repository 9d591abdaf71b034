"""Training losses, computed in float32 (port of
``glow_tts_tpu/training/losses.py``).

* :func:`mle_loss`: the exact flow likelihood: negative log-likelihood of
  z under the aligned prior minus the flow log-determinants, normalised by
  the valid frame count × mel channels, plus the ½·log 2π constant.
* :func:`duration_loss`: mean squared error between predicted and
  MAS-derived log durations over all elements, padding included (both are
  zero there).
* :func:`speaker_ce_loss`: GR mode's adversarial classifier, the mean
  cross-entropy of its logits against the speaker ids.
* :func:`prior_distill_loss`: the 'em' alignment warmup's masked mean
  squared error of the network prior's (mean, log std) against the EM
  table's.
"""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453


def mle_loss(z: torch.Tensor, mel_mean: torch.Tensor,
             mel_log_std: torch.Tensor, log_dets: torch.Tensor,
             mel_lengths: torch.Tensor, num_squeeze: int,
             mel_dim: int) -> torch.Tensor:
    z, mean, log_std = z.float(), mel_mean.float(), mel_log_std.float()
    nll = (torch.sum(log_std)
           + 0.5 * torch.sum(torch.exp(-2.0 * log_std) * (z - mean) ** 2)
           - torch.sum(log_dets.float()))
    frames = torch.div(mel_lengths, num_squeeze, rounding_mode='floor')
    denom = torch.sum(frames) * num_squeeze * mel_dim
    return nll / denom + 0.5 * LOG_2PI


def duration_loss(log_durations: torch.Tensor,
                  log_duration_targets: torch.Tensor) -> torch.Tensor:
    diff = log_durations.float() - log_duration_targets.float()
    return torch.mean(diff ** 2)


def prior_distill_loss(prior_mean: torch.Tensor,
                       prior_log_std: torch.Tensor,
                       distill_mean: torch.Tensor,
                       distill_log_std: torch.Tensor,
                       token_mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE of the network prior's ``(mean, log_std) [B, T_tok, C]``
    against the EM table's at the batch's tokens, over the valid tokens ×
    channels.  Plain MSE on purpose: the MLE gradient of the mean is
    preconditioned by exp(−2·log_std), which lets the prior underfit the
    closed-form optimum the targets are."""
    m = token_mask.float()
    n = torch.sum(m).clamp_min(1.0) * prior_mean.shape[-1]
    d_mean = (prior_mean.float() - distill_mean) * m
    d_std = (prior_log_std.float() - distill_log_std) * m
    return (torch.sum(d_mean ** 2) + torch.sum(d_std ** 2)) / n


def speaker_ce_loss(logits: torch.Tensor,
                    speaker_ids: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(logp.gather(-1, speaker_ids.long()[:, None]))
