"""Core layers of the port, channels-last ([B, T, C]) at every public
function, as in ``glow_tts_tpu/models/layers.py``.

Parameters carry the reference's state-dict names and torch layouts
(conv weight ``[out, in, k]``), the names ``glow_tts_tpu/utils/
torch_export.py`` writes, so an exported checkpoint loads with
``strict=True``.  Dropout (:class:`Dropout`) is live only on the train
path (``deterministic=False``) and draws from a ``torch.Generator`` the
caller hands down; serving and evaluation are deterministic.

The compute dtype is an attribute of the modules (:class:`ComputesAt`,
flax's ``dtype``), which the parameters do not have: they stay float32, so
one state dict serves a bfloat16 train model and a float32 serving model
(:func:`set_compute_dtype`).  At bfloat16 each layer casts as its JAX
counterpart does (``glow_tts_tpu/models/layers.py``), with explicit casts:
the convs and projections take input, kernel and bias in bfloat16; the
LayerNorm keeps float32 statistics and returns bfloat16; attention scores,
the relative-position terms and the alignment products sum in float32
(``ops/precision.py``), the alignments cast back to the values' dtype.  At
float32 every layer computes what it did before the dtype existed.

Under tensor parallelism (``parallel/tp.py``) a module of a sharded family
holds its slice of the weights and takes its model group's world
(``shard``): the attention computes its rank's heads, a row-parallel
:class:`Conv1d` sums its partial products over the group in float32 before
it rounds and adds the bias, a row-sharded :class:`WNConv1d` sums the
squares of its weight norm over the group, and a dropout on a sharded
activation draws the whole mask and keeps its slice, so the masks are a
world of one's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.ops import attention as attn_ops
from glow_tts_tpu_torch.ops.coupling import tap_conv
from glow_tts_tpu_torch.ops.precision import conv_float32, rounded
from glow_tts_tpu_torch.parallel.tp import copy_to_model, reduce_from_model


class ComputesAt:
    """A module that computes at ``dtype`` (float32 unless
    :func:`set_compute_dtype` says otherwise): an attribute, not a
    parameter or a buffer."""
    dtype: torch.dtype = torch.float32


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every :class:`ComputesAt` below ``module`` (itself included)
    computes at ``dtype`` from now on."""
    for sub in module.modules():
        if isinstance(sub, ComputesAt):
            sub.dtype = dtype


def bf16_scale(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A scalar constant in ``dtype`` (``jnp.asarray(value, dtype)``),
    as a 0-d tensor."""
    return torch.tensor(value, dtype=torch.float32).to(dtype)


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
                generator: Optional[torch.Generator] = None,
                shard: Optional[Tuple[int, object]] = None) -> torch.Tensor:
        """``shard`` ``(dim, world)``: ``x`` is this rank's slice along
        ``dim`` of an activation sharded over ``world``'s model group; the
        whole activation's mask is drawn (every rank draws the same) and
        this rank's slice of it kept."""
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError('Dropout needs a torch.Generator on the '
                             "tensor's device when it is not deterministic")
        if shard is None or shard[1].model_size == 1:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= self.rate
        else:
            dim, world = shard
            shape = list(x.shape)
            part = shape[dim]
            shape[dim] = part * world.model_size
            keep = (torch.rand(shape, generator=generator, device=x.device)
                    >= self.rate).narrow(dim, world.model_index * part, part)
        if x.dtype == torch.float32:
            return x * keep.to(x.dtype) * (1.0 / (1.0 - self.rate))
        # the scale in the input's dtype, as FastDropout's
        scale = bf16_scale(1.0 / (1.0 - self.rate), x.dtype).to(x.device)
        return x * scale * keep.to(x.dtype)


class Conv1d(nn.Module, ComputesAt):
    """SAME-padded convolution over the time axis of ``x [B, T, Cin]``
    with a torch-layout weight ``[Cout, Cin, k]``; 1×1 runs as a matmul,
    k taps at float32 in float32 forward and backward
    (``ops.precision.conv_float32``: cuDNN takes TF32 on a card under
    PyTorch's default flags).  At bfloat16 input, kernel and bias are cast to it, and so is the
    output (flax's ``nn.Dense``/``nn.Conv`` with ``dtype``).  Row-parallel
    (``reduce_over``, a world whose model group shares the input
    channels): the partial products summed over the group in float32,
    then rounded to the dtype, then the bias added."""

    reduce_over = None

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1):
        super().__init__()
        assert kernel_size % 2 == 1, 'SAME padding needs an odd kernel'
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.reduce_over is not None:
            # bf16 operands multiply exactly in float32: the partial sums
            # in float32 (products, not cuDNN's TF32 convolution), rounded
            # once after the group's sum
            x = x.to(self.dtype).float()
            weight = self.weight.to(self.dtype).float()
            y = tap_conv(x, weight.permute(2, 1, 0))
            y = reduce_from_model(y, self.reduce_over)
            return y.to(self.dtype) + self.bias.to(self.dtype)
        if self.dtype != torch.float32:
            # the product rounded to the dtype, then the bias added in it:
            # two roundings, as XLA computes flax's bfloat16 layers
            x, weight = x.to(self.dtype), self.weight.to(self.dtype)
            if k == 1:
                y = F.linear(x, weight[:, :, 0])
            else:
                y = F.conv1d(x.transpose(1, 2), weight,
                             padding=(k - 1) // 2).transpose(1, 2)
            return y + self.bias.to(self.dtype)
        if k == 1:
            return F.linear(x, self.weight[:, :, 0], self.bias)
        return conv_float32(x.transpose(1, 2), self.weight, self.bias, 1,
                            (k - 1) // 2).transpose(1, 2)


class LayerNorm(nn.LayerNorm, ComputesAt):
    """``nn.LayerNorm`` over the channels (the reference's eps 1e-4): at
    bfloat16 the statistics and the affine are float32 and the result is
    cast to bfloat16 (flax's ``nn.LayerNorm(dtype=...)``)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class WNConv1d(nn.Module):
    """Weight-normalised conv parameters (torch ``weight_norm`` dim-0:
    one magnitude ``weight_g`` per output channel, direction ``weight_v``
    normalised over (in, k)).

    Only the coupling WaveNet uses it, and only through the packed
    flow-step weights, so it exposes the effective kernel rather than a
    forward.  :meth:`fold` fixes that kernel once for serving, as
    ``fold_weight_norm_params`` does in the JAX package.  A row-sharded
    ``weight_v`` (``norm_over``, the world of its model group) sums the
    squares of its norm over the group before the division."""

    norm_over = None

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
        return _weight_norm(self.weight_g, self.weight_v, self.norm_over)

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
    return (_weight_norm(g, v, convs[0].norm_over),
            torch.stack([conv.bias for conv in convs]))


def _weight_norm(g: torch.Tensor, v: torch.Tensor, world=None
                 ) -> torch.Tensor:
    """``g · v / ‖v‖``, the norm over the last two axes (in, k) of ``v
    [..., out, in, k]``.  Over a model group (``world``) that shares the
    input rows the squares are summed over it; the norm and ``g`` are then
    replicated values entering this rank's slice, so both pass
    ``copy_to_model`` and their gradients add up over the group."""
    squares = v.pow(2).sum(dim=(-2, -1), keepdim=True)
    if world is None or world.model_size == 1:
        return g * v / squares.sqrt().clamp_min(1e-12)
    norm = reduce_from_model(squares, world).sqrt().clamp_min(1e-12)
    g, norm = copy_to_model(torch.stack([g, norm]), world).unbind()
    return g * v / norm


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
    deterministic.  Sharded (:meth:`shard`) it computes its rank's heads:
    the relative tables, shared across heads, stay whole."""

    tp = None

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

    def shard(self, world) -> None:
        """Compute the heads of this rank of ``world``'s model group, on
        Query/Key/Value sliced by whole heads and the projection's input
        rows (``parallel/tp.py``): the projection's partial sums are added
        over the group before its bias, and the relative tables, which
        every head reads, sum their gradients over the group."""
        self.tp = world
        self.layer_Dict['Projection'].reduce_over = world

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C]; attn_mask [B, 1, T, T] (1 = attend).
        Returns (out [B, T, C], alignments [B, H, T, T])."""
        b, t, c = x.shape
        d = c // self.num_heads
        # this rank's heads (all of them in a world of one)
        h = self.num_heads // (self.tp.model_size if self.tp else 1)
        layers = self.layer_Dict

        def heads(y):
            return y.reshape(b, t, h, d).transpose(1, 2)     # [B, H, T, d]

        x = copy_to_model(x, self.tp)
        q = heads(layers['Query'](x))
        k = heads(layers['Key'](x))
        v = heads(layers['Value'](x))

        skew_k = attn_ops.skewed_relative_table(
            attn_ops.clip_relative_embedding(
                copy_to_model(self.weight_K, self.tp), t), t)[0]
        if q.dtype == torch.float32:
            scale = 1.0 / math.sqrt(d)
            scores = (q @ k.transpose(-1, -2)
                      + torch.einsum('bhqd,qkd->bhqk', q, skew_k)) * scale
        else:
            # bf16 projections, float32 sums; the scale rounded to q's dtype
            scale = (1.0 / bf16_scale(math.sqrt(d), q.dtype)).float().to(
                q.device)
            q, k = q.float(), k.float()
            scores = ((q @ k.transpose(-1, -2)) * scale
                      + torch.einsum('bhqd,qkd->bhqk', q, skew_k) * scale)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        alignments = self.dropout(torch.softmax(scores, dim=-1),
                                  deterministic, generator,
                                  None if self.tp is None else (1, self.tp))

        skew_v = attn_ops.skewed_relative_table(
            attn_ops.clip_relative_embedding(
                copy_to_model(self.weight_V, self.tp), t), t)[0]
        # the alignments meet the values in the values' dtype
        out = (rounded(alignments, v.dtype) @ v.float()
               + torch.einsum('bhqk,qkd->bhqd', alignments, skew_v))
        out = out.transpose(1, 2).reshape(b, t, h * d).to(x.dtype)
        return layers['Projection'](out), alignments


class MultiHeadCrossAttention(nn.Module):
    """Plain multi-head attention of queries over keys, no relative
    positions and no mask: the JAX ``RelativePositionMultiHeadAttention``
    with ``window_size=None``, as the GST prosody encoder uses it over its
    style tokens (``glow_tts_tpu/models/conditioning.py``).  Projections are
    1×1 convs under the reference's names (Query, Key, Value, Projection)."""

    def __init__(self, query_channels: int, key_channels: int,
                 channels: int, out_channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.layer_Dict = nn.ModuleDict({
            'Query': Conv1d(query_channels, channels, 1),
            'Key': Conv1d(key_channels, channels, 1),
            'Value': Conv1d(key_channels, channels, 1),
            'Projection': Conv1d(channels, out_channels, 1)})

    def forward(self, queries: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
        """queries [B, T_q, C_q], keys [B, T_k, C_k] (also the values) →
        [B, T_q, out]."""
        layers = self.layer_Dict
        h = self.num_heads

        def heads(y):
            b, t, c = y.shape
            return y.reshape(b, t, h, c // h).transpose(1, 2)

        q = heads(layers['Query'](queries))
        k = heads(layers['Key'](keys))
        v = heads(layers['Value'](keys))
        if q.dtype == torch.float32:
            scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
            out = torch.softmax(scores, dim=-1) @ v          # [B, H, Tq, d]
        else:
            scale = (1.0 / bf16_scale(math.sqrt(q.shape[-1]), q.dtype)
                     ).float().to(q.device)
            scores = (q.float() @ k.float().transpose(-1, -2)) * scale
            out = (rounded(torch.softmax(scores, dim=-1), v.dtype)
                   @ v.float()).to(queries.dtype)
        b, _, t_q, d = out.shape
        return layers['Projection'](out.transpose(1, 2).reshape(b, t_q,
                                                                 h * d))
