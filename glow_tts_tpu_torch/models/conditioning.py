"""Conditioning encoders of the SE, PE and GR modes (port of
``glow_tts_tpu/models/conditioning.py``): the speaker look-up table, the
GE2E d-vector encoder, the GST prosody encoder, the adversarial speaker
classifier and the per-sample pitch interpolation.

These are small recurrent and convolutional nets that the JAX package
computes with XLA's own ops (no Pallas kernel), so the port runs them as
PyTorch's library modules (``nn.LSTM``, ``nn.GRU``, ``nn.Conv2d``).
Parameters carry the reference's state-dict names and layouts (those
``glow_tts_tpu/utils/torch_export.py`` writes); the GE2E encoder, which
the reference loads from a checkpoint of its own, keeps ``nn.LSTM``'s and
``nn.Linear``'s names under ``GE2E.layer_Dict``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.models.layers import Conv1d, MultiHeadCrossAttention
from glow_tts_tpu_torch.ops.grl import gradient_reversal


def ge2e_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise embeddings along the last axis."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class GE2ESpeakerEncoder(nn.Module):
    """Stacked LSTM over mel slices, its last step projected and
    normalised: ``[B·S, T_slice, M]`` → ``[B·S, E]``."""

    def __init__(self, config):
        super().__init__()
        cfg = config.speaker_embedding
        self.samples = cfg.ge2e.inference.samples
        self.layer_Dict = nn.ModuleDict({
            'LSTM': nn.LSTM(config.sound.mel_dim, cfg.ge2e.lstm.sizes,
                            num_layers=cfg.ge2e.lstm.stacks,
                            batch_first=True),
            'Projection': nn.Linear(cfg.ge2e.lstm.sizes,
                                    cfg.embedding_size)})

    def forward(self, mel_slices: torch.Tensor) -> torch.Tensor:
        x, _ = self.layer_Dict['LSTM'](mel_slices)
        return ge2e_normalize(self.layer_Dict['Projection'](x[:, -1]))

    def embed_utterances(self, mel_slices: torch.Tensor) -> torch.Tensor:
        """``[B·S, T_slice, M]`` → ``[B, E]``: the S slices of each
        utterance averaged and normalised again."""
        per_slice = self(mel_slices)
        pooled = per_slice.reshape(-1, self.samples,
                                   per_slice.shape[-1]).mean(dim=1)
        return ge2e_normalize(pooled)


class _Conv(nn.Module):
    """The reference's ``Conv_{i}.Conv`` nesting of a bare Conv2d."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.Conv = conv


def _without_rz(grad: torch.Tensor, size: int) -> torch.Tensor:
    """A GRU ``bias_hh`` gradient with its r and z rows zero."""
    return torch.cat([torch.zeros_like(grad[:2 * size]), grad[2 * size:]])


class GSTProsodyEncoder(nn.Module):
    """Global style tokens over a reference mel: strided Conv2d stack →
    GRU → its last valid step → attention over ``tanh`` of the learned
    tokens.  ``mels [B, T, M]``, ``mel_lengths [B]`` → ``[B, P]``."""

    def __init__(self, config):
        super().__init__()
        cfg = config.prosody_encoder
        ref = cfg.reference_encoder
        self.strides = tuple(ref.conv.strides)
        modules = {}
        in_channels, freq = 1, config.sound.mel_dim
        for i, (k, ch, s) in enumerate(zip(ref.conv.kernel_size,
                                           ref.conv.channels, ref.conv.strides)):
            pad = (k - 1) // 2
            modules[f'Conv_{i}'] = _Conv(nn.Conv2d(
                in_channels, ch, k, stride=s, padding=pad, bias=False))
            in_channels = ch
            freq = (freq + 2 * pad - k) // s + 1
        modules['GRU'] = nn.GRU(in_channels * freq, ref.gru.size,
                                num_layers=ref.gru.stacks, batch_first=True)
        for i in range(ref.gru.stacks):
            # flax's GRU cell has one bias for each of r and z, the torch
            # layer two that add up (bias_ih + bias_hh): bias_hh's r and z
            # rows get no gradient, so training moves that sum as the JAX
            # package moves its one bias
            getattr(modules['GRU'], f'bias_hh_l{i}').register_hook(
                functools.partial(_without_rz, size=ref.gru.size))
        modules['Attention'] = MultiHeadCrossAttention(
            ref.gru.size, cfg.style_token.size, cfg.size, cfg.size,
            cfg.style_token.attention_head)
        self.layer_Dict = nn.ModuleDict(modules)
        # [token size, tokens], the reference's layout
        self.gst_Tokens = nn.Parameter(torch.empty(
            cfg.style_token.size, cfg.style_token.num_tokens))

    def forward(self, mels: torch.Tensor,
                mel_lengths: torch.Tensor) -> torch.Tensor:
        layers = self.layer_Dict
        x = mels.transpose(1, 2)[:, None]                  # [B, 1, M, T]
        for i in range(len(self.strides)):
            x = F.relu(layers[f'Conv_{i}'].Conv(x))        # [B, C, F, T']
        b, c, f, t = x.shape
        # channel-major flatten of (chan, freq) at each step
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * f)
        x, _ = layers['GRU'](x)
        total_stride = math.prod(self.strides)
        last = torch.div(mel_lengths.long() + total_stride - 1, total_stride,
                         rounding_mode='floor') - 1
        last = last.clamp(0, t - 1)
        summary = x[torch.arange(b, device=x.device), last]     # [B, GRU]
        keys = torch.tanh(self.gst_Tokens.t())[None].expand(b, -1, -1)
        return layers['Attention'](summary[:, None], keys)[:, 0]


class SpeakerClassifier(nn.Module):
    """GR mode's adversarial classifier on the prosody vector, behind the
    gradient reversal: ``[B, P]`` → speaker logits ``[B, speakers]``."""

    def __init__(self, config):
        super().__init__()
        widths = [config.prosody_encoder.size,
                  *config.speaker_classifier_gr.channels]
        self.weight = config.train.adversarial_speaker_weight
        self.hidden = len(widths) - 1
        layers = {f'Hidden_{i}': Conv1d(widths[i], widths[i + 1], 1)
                  for i in range(self.hidden)}
        layers[f'Output_{self.hidden - 1}'] = Conv1d(
            widths[-1], config.speaker_embedding.num_speakers, 1)
        self.layer = nn.ModuleDict(layers)

    def forward(self, prosody: torch.Tensor) -> torch.Tensor:
        x = gradient_reversal(prosody, self.weight)
        for i in range(self.hidden):
            x = F.relu(self.layer[f'Hidden_{i}'](x))
        return self.layer[f'Output_{self.hidden - 1}'](x)


def interpolate_pitch(pitches: torch.Tensor, base_lengths: torch.Tensor,
                      new_lengths: torch.Tensor,
                      max_new_length: int) -> torch.Tensor:
    """Each pitch track resampled linearly from its base length to its new
    length (align_corners), zero from the new length on: ``pitches
    [B, T_base]``, lengths ``[B]`` → ``[B, max_new_length]``."""
    t_base = pitches.shape[1]
    out_pos = torch.arange(max_new_length, device=pitches.device)[None, :]
    denom = (new_lengths[:, None] - 1).clamp_min(1)
    src = out_pos * (base_lengths[:, None] - 1) / denom
    src = src.clamp(0, t_base - 1)
    lo = torch.floor(src).long()
    hi = (lo + 1).clamp_max(t_base - 1)
    frac = (src - lo).to(pitches.dtype)
    gathered = (torch.gather(pitches, 1, lo) * (1 - frac)
                + torch.gather(pitches, 1, hi) * frac)
    return torch.where(out_pos < new_lengths[:, None], gathered,
                       torch.zeros_like(gathered))
