"""Text encoder: prenet → relative-position transformer → prior projection
and duration predictor (port of ``glow_tts_tpu/models/encoder.py``).  In
the conditioned modes the duration predictor also reads the conditioning
vector, broadcast over the tokens and concatenated to its input.
``deterministic=False`` turns on dropout at the JAX package's sites, drawn
from the ``generator`` handed down; the duration predictor reads detached
encodings and a detached conditioning vector.  At bfloat16 (the modules'
``dtype``, ``models/layers.py``) the embedding is cast and scaled in it,
and the activations stay bfloat16 through every layer, as
``glow_tts_tpu/models/encoder.py`` computes them; mean, log std and
log-durations come out in it.  Under tensor parallelism
(``parallel/tp.py``) a transformer block's FFN and the duration
predictor's first two convs are column- and row-parallel pairs over the
model group (:meth:`TransformerBlock.shard`,
:meth:`DurationPredictor.shard`), and the attention computes its rank's
heads."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.models.layers import (
    ComputesAt, Conv1d, Dropout, Embedding, LayerNorm,
    RelativePositionMultiHeadAttention, bf16_scale, masked)
from glow_tts_tpu_torch.parallel.tp import copy_to_model


def _layer_norm(channels: int) -> LayerNorm:
    return LayerNorm(channels, eps=1e-4)


class _Named(nn.Module):
    """A bare ``layer_Dict`` holder: the reference nests many blocks one
    level deeper than their math needs, and the state-dict names follow."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        self.layer_Dict = nn.ModuleDict(modules)


class Prenet(nn.Module):
    def __init__(self, config):
        super().__init__()
        cfg = config.encoder
        c = cfg.channels
        self.layer_Dict = nn.ModuleDict({
            **{f'CLRD_{i}': _Named(Conv=Conv1d(c, c, cfg.prenet.kernel_size),
                                   LayerNorm=_layer_norm(c))
               for i in range(cfg.prenet.stacks)},
            'Conv1x1': Conv1d(c, c, 1)})
        self.stacks = cfg.prenet.stacks
        self.dropout = Dropout(cfg.prenet.dropout_rate)

    def forward(self, x, mask, deterministic=True, generator=None):
        residual = x
        for i in range(self.stacks):
            block = self.layer_Dict[f'CLRD_{i}'].layer_Dict
            x = F.relu(block['LayerNorm'](block['Conv'](masked(x, mask))))
            x = self.dropout(x, deterministic, generator)
        return masked(self.layer_Dict['Conv1x1'](x) + residual, mask)


class TransformerBlock(nn.Module):
    tp = None

    def __init__(self, config):
        super().__init__()
        c = config.encoder.channels
        cfg = config.encoder.transformer
        self.layer_Dict = nn.ModuleDict({
            'Attention': RelativePositionMultiHeadAttention(
                c, cfg.attention.heads, cfg.attention.window_size,
                cfg.dropout_rate),
            'LayerNorm_0': _layer_norm(c),
            'Conv_0': Conv1d(c, cfg.conv.calc_channels, cfg.conv.kernel_size),
            'Conv_1': Conv1d(cfg.conv.calc_channels, c, cfg.conv.kernel_size),
            'LayerNorm_1': _layer_norm(c)})
        self.dropout = Dropout(cfg.dropout_rate)

    def shard(self, world) -> None:
        """The FFN over ``world``'s model group: ``Conv_0`` column-parallel
        over the hidden channels, ``Conv_1`` row-parallel."""
        self.tp = world
        self.layer_Dict['Conv_1'].reduce_over = world

    def forward(self, x, mask, attn_mask, deterministic=True,
                generator=None):
        layers = self.layer_Dict

        def drop(y, shard=None):
            return self.dropout(y, deterministic, generator, shard)

        x = masked(x, mask)
        y, _ = layers['Attention'](x, attn_mask, deterministic, generator)
        x = layers['LayerNorm_0'](drop(y) + x)
        y = drop(F.relu(layers['Conv_0'](masked(copy_to_model(x, self.tp),
                                                mask))),
                 None if self.tp is None else (2, self.tp))
        y = drop(layers['Conv_1'](masked(y, mask)))
        return layers['LayerNorm_1'](masked(y, mask) + x)


class DurationPredictor(nn.Module):
    tp = None

    def __init__(self, config):
        super().__init__()
        cfg = config.encoder.duration_predictor
        widths = ([config.encoder.channels + config.condition_size]
                  + [cfg.channels] * cfg.stacks)
        self.layer_Dict = nn.ModuleDict({
            **{f'CRND_{i}': _Named(Conv=Conv1d(widths[i], widths[i + 1],
                                               cfg.kernel_size))
               for i in range(cfg.stacks)},
            'Projection': Conv1d(cfg.channels, 1, 1)})
        self.stacks = cfg.stacks
        self.dropout = Dropout(cfg.dropout_rate)

    def shard(self, world) -> None:
        """``CRND_0`` column-parallel over ``world``'s model group and
        ``CRND_1`` row-parallel; the projection stays whole."""
        self.tp = world
        self.layer_Dict['CRND_1'].layer_Dict['Conv'].reduce_over = world

    def forward(self, x, mask, condition: Optional[torch.Tensor] = None,
                deterministic=True, generator=None):
        """x [B, T, C], already detached from the encoder; ``condition
        [B, E]`` or None."""
        if condition is not None:
            x = torch.cat([x, condition[:, None, :].expand(
                -1, x.shape[1], -1).to(x.dtype)], dim=-1)
        x = copy_to_model(x, self.tp)
        for i in range(self.stacks):
            conv = self.layer_Dict[f'CRND_{i}'].layer_Dict['Conv']
            # CRND_0's output is sharded over the model group
            shard = (2, self.tp) if self.tp is not None and i == 0 else None
            x = self.dropout(F.relu(conv(masked(x, mask))), deterministic,
                             generator, shard)
        return masked(self.layer_Dict['Projection'](masked(x, mask)), mask)


class TextEncoder(nn.Module, ComputesAt):
    """Token ids → per-token Gaussian prior (mean, log_std) and
    log-durations."""

    def __init__(self, config):
        super().__init__()
        cfg = config.encoder
        self.channels = cfg.channels
        self.layer_Dict = nn.ModuleDict({
            'Embedding': Embedding(cfg.embedding_tokens, cfg.channels),
            'Prenet': Prenet(config),
            'Transformer': _Named(**{
                f'ANCRDCN_{i}': TransformerBlock(config)
                for i in range(cfg.transformer.stacks)}),
            'Project': Conv1d(cfg.channels, 2 * config.sound.mel_dim, 1),
            'Duration_Predictor': DurationPredictor(config)})

    def forward(self, tokens, mask, condition=None, deterministic=True,
                generator=None):
        """tokens [B, T] int64; mask [B, T, 1]; ``condition [B, E]`` (the
        conditioned modes' vector) or None.  Returns (mean [B, T, M],
        log_std [B, T, M], log_durations [B, T, 1]).  The duration
        predictor sees detached features and conditioning, so the duration
        loss trains the predictor alone."""
        layers = self.layer_Dict
        x = layers['Embedding'](tokens)
        if self.dtype == torch.float32:
            x = x * math.sqrt(self.channels)
        else:
            x = x.to(self.dtype) * bf16_scale(math.sqrt(self.channels),
                                              self.dtype).to(x.device)
        x = layers['Prenet'](x, mask, deterministic, generator)
        m = mask[..., 0]
        attn_mask = m[:, None, :, None] * m[:, None, None, :]   # [B,1,T,T]
        for block in layers['Transformer'].layer_Dict.values():
            x = block(x, mask, attn_mask, deterministic, generator)
        x = masked(x, mask)
        mean, log_std = masked(layers['Project'](x), mask).chunk(2, dim=-1)
        log_durations = layers['Duration_Predictor'](
            x.detach(), mask,
            None if condition is None else condition.detach(),
            deterministic, generator)
        return mean, log_std, log_durations
