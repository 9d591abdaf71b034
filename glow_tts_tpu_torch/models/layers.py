"""Core layers of the port, channels-last ([B, T, C]) at every public
function, as in ``glow_tts_tpu/models/layers.py``.

Parameters carry the reference's state-dict names and torch layouts
(conv weight ``[out, in, k]``), the names ``glow_tts_tpu/utils/
torch_export.py`` writes, so an exported checkpoint loads with
``strict=True``.  Dropout (:class:`Dropout`) is live only on the train
path (``deterministic=False``) and draws from a ``torch.Generator`` the
caller hands down; serving and evaluation are deterministic.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.ops import attention as attn_ops


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x * mask.to(x.dtype)


def sequence_mask(lengths: torch.Tensor, max_length: int,
                  dtype=torch.float32) -> torch.Tensor:
    """[B] lengths → [B, T, 1] mask."""
    frames = torch.arange(max_length, device=lengths.device)
    return (frames[None, :] < lengths[:, None])[..., None].to(dtype)


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is the tokens' one-hot matrix
    times the output gradient: one matrix product, which sums in a fixed
    order, where the library's backward accumulates with atomics on a card
    and differs from run to run in the last bits."""

    @staticmethod
    def forward(ctx, tokens, weight):
        ctx.save_for_backward(tokens)
        ctx.num_tokens = weight.shape[0]
        return F.embedding(tokens, weight)

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        one_hot = F.one_hot(tokens.reshape(-1).long(),
                            ctx.num_tokens).to(grad.dtype)
        return None, one_hot.t() @ grad.reshape(-1, grad.shape[-1])


class Embedding(nn.Embedding):
    """``nn.Embedding`` (same parameter, same values) with a weight
    gradient that is the same in every run, so a resumed run repeats an
    uninterrupted one on the card too."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _Lookup.apply(tokens, self.weight)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator: drop
    each element with probability ``rate`` and scale the kept ones by
    ``1/(1 − rate)``.  The identity when ``deterministic`` or at rate 0.
    The contract is statistical (rate, scale, the same stream from the
    same generator state), as ``glow_tts_tpu.models.layers.FastDropout``'s
    is; the bits differ from JAX's."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f'dropout rate must be in [0, 1), got {rate}')
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError('Dropout needs a torch.Generator on the '
                             "tensor's device when it is not deterministic")
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= self.rate
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.rate))


class Conv1d(nn.Module):
    """SAME-padded convolution over the time axis of ``x [B, T, Cin]``
    with a torch-layout weight ``[Cout, Cin, k]``; 1×1 runs as a matmul."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1):
        super().__init__()
        assert kernel_size % 2 == 1, 'SAME padding needs an odd kernel'
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if k == 1:
            return F.linear(x, self.weight[:, :, 0], self.bias)
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     padding=(k - 1) // 2)
        return y.transpose(1, 2)


class WNConv1d(nn.Module):
    """Weight-normalised conv parameters (torch ``weight_norm`` dim-0:
    one magnitude ``weight_g`` per output channel, direction ``weight_v``
    normalised over (in, k)).

    Only the coupling WaveNet uses it, and only through the packed
    flow-step weights, so it exposes the effective kernel rather than a
    forward.  :meth:`fold` fixes that kernel once for serving, as
    ``fold_weight_norm_params`` does in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1):
        super().__init__()
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer('folded', None, persistent=False)

    def effective_weight(self) -> torch.Tensor:
        if self.folded is not None:
            return self.folded
        v = self.weight_v
        norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        return self.weight_g * v / norm.clamp_min(1e-12)

    @torch.no_grad()
    def fold(self) -> None:
        self.folded = None
        self.folded = self.effective_weight().detach().clone()

    def unfold(self) -> None:
        """Back to ``weight_g``/``weight_v``, as training needs them."""
        self.folded = None


def stacked_effective_weights(convs: Sequence[WNConv1d]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The effective kernels ``[S, out, in, k]`` and biases ``[S, out]`` of
    ``S`` unfolded convs of one shape, differentiable down to each conv's
    ``weight_g``/``weight_v``: the arithmetic of
    :meth:`WNConv1d.effective_weight` in one pass over the stack instead of
    one per conv."""
    if any(conv.folded is not None for conv in convs):
        raise RuntimeError('weight norm is folded: the train path needs '
                           'weight_g/weight_v live (GlowTTS.prepare('
                           'fold=False))')
    g = torch.stack([conv.weight_g for conv in convs])
    v = torch.stack([conv.weight_v for conv in convs])
    norm = v.pow(2).sum(dim=(2, 3), keepdim=True).sqrt()
    return (g * v / norm.clamp_min(1e-12),
            torch.stack([conv.bias for conv in convs]))


def fold_weight_norm(module: nn.Module, fold: bool = True) -> None:
    """Fold weight norm into every :class:`WNConv1d` below ``module``, or
    drop the folded kernels again (``fold=False``)."""
    for sub in module.modules():
        if isinstance(sub, WNConv1d):
            sub.fold() if fold else sub.unfold()


class RelativePositionMultiHeadAttention(nn.Module):
    """Self-attention with window-clipped relative position embeddings
    shared across heads (reference ``RPR_MHA.py``; JAX
    ``layers.py:340-472``); dropout on the attention weights when not
    deterministic."""

    def __init__(self, channels: int, num_heads: int, window_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = Dropout(dropout_rate)
        d = channels // num_heads
        self.layer_Dict = nn.ModuleDict({
            name: Conv1d(channels, channels, 1)
            for name in ('Query', 'Key', 'Value', 'Projection')})
        self.weight_K = nn.Parameter(torch.empty(1, 2 * window_size + 1, d))
        self.weight_V = nn.Parameter(torch.empty(1, 2 * window_size + 1, d))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C]; attn_mask [B, 1, T, T] (1 = attend).
        Returns (out [B, T, C], alignments [B, H, T, T])."""
        b, t, c = x.shape
        h = self.num_heads
        d = c // h
        layers = self.layer_Dict

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)     # [B, H, T, d]

        q = heads(layers['Query'](x))
        k = heads(layers['Key'](x))
        v = heads(layers['Value'](x))
        scale = 1.0 / math.sqrt(d)

        skew_k = attn_ops.skewed_relative_table(
            attn_ops.clip_relative_embedding(self.weight_K, t), t)[0]
        scores = (q @ k.transpose(-1, -2)
                  + torch.einsum('bhqd,qkd->bhqk', q, skew_k)) * scale
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        alignments = self.dropout(torch.softmax(scores, dim=-1),
                                  deterministic, generator)

        skew_v = attn_ops.skewed_relative_table(
            attn_ops.clip_relative_embedding(self.weight_V, t), t)[0]
        out = (alignments @ v
               + torch.einsum('bhqk,qkd->bhqd', alignments, skew_v))
        out = out.transpose(1, 2).reshape(b, t, c)
        return layers['Projection'](out), alignments
