"""Gradient reversal (GR mode's adversarial speaker classifier), port of
``glow_tts_tpu/ops/grl.py``: the identity forward, the gradient scaled by
``−weight`` backward."""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = float(weight)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -ctx.weight * grad, None


def gradient_reversal(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """``x`` unchanged; its gradient multiplied by ``−weight``."""
    return _GradientReversal.apply(x, weight)
