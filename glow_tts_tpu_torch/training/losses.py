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

Under data parallelism each loss is that of the global batch, whose rows
the ranks share (``parallel/data.py``): a caller that holds a rank's rows
passes the global batch's counts (``training/step.py::
loss_denominators``: the valid frames and tokens summed over the ranks;
the global batch and the longest padded token axis among them, which is
the padding one collation of the whole batch would give), and a rank's
value is its own rows' sum over them, so the ranks' values sum to the
loss of the whole batch, and so do their gradients.  Rank 0 alone adds
the MLE's constant.  Without the counts each loss is the mean over its
own batch.  The losses themselves reduce nothing across ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

LOG_2PI = 1.8378770664093453


def mle_loss(z: torch.Tensor, mel_mean: torch.Tensor,
             mel_log_std: torch.Tensor, log_dets: torch.Tensor,
             mel_lengths: torch.Tensor, num_squeeze: int,
             mel_dim: int, frames: Optional[torch.Tensor] = None,
             constant: bool = True) -> torch.Tensor:
    """``frames``: the valid flow frames of the global batch (by default
    this batch's); ``constant``: add ½·log 2π (rank 0 alone does)."""
    z, mean, log_std = z.float(), mel_mean.float(), mel_log_std.float()
    nll = (torch.sum(log_std)
           + 0.5 * torch.sum(torch.exp(-2.0 * log_std) * (z - mean) ** 2)
           - torch.sum(log_dets.float()))
    if frames is None:
        frames = torch.sum(torch.div(mel_lengths, num_squeeze,
                                     rounding_mode='floor'))
    denom = frames * num_squeeze * mel_dim
    return nll / denom + (0.5 * LOG_2PI if constant else 0.0)


def duration_loss(log_durations: torch.Tensor,
                  log_duration_targets: torch.Tensor,
                  batch: Optional[int] = None,
                  token_axis: Optional[int] = None) -> torch.Tensor:
    """Over ``[B, T_tok, ...]``, padding included; ``batch`` and
    ``token_axis`` are the global batch's ``B`` and ``T_tok`` (by default
    this batch's)."""
    diff = log_durations.float() - log_duration_targets.float()
    if batch is None and token_axis is None:
        return torch.mean(diff ** 2)
    rows, t_tok = diff.shape[:2]
    count = (diff.numel() // (rows * t_tok) * (batch or rows)
             * (token_axis or t_tok))
    return torch.sum(diff ** 2) / count


def prior_distill_loss(prior_mean: torch.Tensor,
                       prior_log_std: torch.Tensor,
                       distill_mean: torch.Tensor,
                       distill_log_std: torch.Tensor,
                       token_mask: torch.Tensor,
                       tokens: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked MSE of the network prior's ``(mean, log_std) [B, T_tok, C]``
    against the EM table's at the batch's tokens, over the valid tokens ×
    channels.  Plain MSE on purpose: the MLE gradient of the mean is
    preconditioned by exp(−2·log_std), which lets the prior underfit the
    closed-form optimum the targets are.  ``tokens``: the valid tokens of
    the global batch (by default ``token_mask``'s)."""
    m = token_mask.float()
    if tokens is None:
        tokens = torch.sum(m)
    n = tokens.float().clamp_min(1.0) * prior_mean.shape[-1]
    d_mean = (prior_mean.float() - distill_mean) * m
    d_std = (prior_log_std.float() - distill_log_std) * m
    return (torch.sum(d_mean ** 2) + torch.sum(d_std ** 2)) / n


def speaker_ce_loss(logits: torch.Tensor, speaker_ids: torch.Tensor,
                    batch: Optional[int] = None) -> torch.Tensor:
    """``batch``: the global batch size (by default this batch's)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, speaker_ids.long()[:, None])
    return -torch.sum(picked) / (batch or picked.numel())
