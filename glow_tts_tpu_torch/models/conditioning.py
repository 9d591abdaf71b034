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

At bfloat16 (the modules' ``dtype``, ``models/layers.py``) they cast as the
JAX package's modules do: the GE2E encoder and the GST run their convs,
dense products and gates in bfloat16 while the recurrent carry stays
float32 (flax's cells with ``dtype``, whose carry has the parameters'
dtype), which the library's ``nn.LSTM``/``nn.GRU`` cannot do, so the
recurrences are written out step by step (:func:`lstm_steps`,
:func:`gru_steps`, with the same parameters); the look-up table and the
speaker classifier have no dtype in the JAX package and stay float32.
At float32 nothing reaches cuDNN's TF32, which its float32 convolutions
and RNNs take under PyTorch's default flags: the GST's convs run through
``ops.precision.conv_float32`` (float32 forward and backward), its GRU
takes the written-out steps, and the GE2E LSTM, which is frozen and takes
no backward, runs cuDNN's LSTM inside ``ops.precision.cudnn_float32``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.models.layers import (ComputesAt, Conv1d,
                                              MultiHeadCrossAttention)
from glow_tts_tpu_torch.ops.grl import gradient_reversal
from glow_tts_tpu_torch.ops.precision import conv_float32, cudnn_float32


def _dense(x: torch.Tensor, weight: torch.Tensor,
           bias=None, dtype=torch.bfloat16) -> torch.Tensor:
    """``x . weightᵀ`` in ``dtype`` (rounded there), then ``+ bias``
    rounded there too: flax's ``Dense`` with ``dtype``."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def lstm_steps(lstm: nn.LSTM, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``lstm`` (batch first, gate order i, f, g, o) over ``x [B, T, in]``
    at ``dtype`` as flax's ``OptimizedLSTMCell(dtype=...)`` steps: each
    gate's products and sum in ``dtype`` (the bias on the recurrent side),
    the cell and hidden state float32.  Returns the last layer's outputs
    ``[B, T, H]`` float32."""
    h_size = lstm.hidden_size
    for i in range(lstm.num_layers):
        w_ih = getattr(lstm, f'weight_ih_l{i}')
        w_hh = getattr(lstm, f'weight_hh_l{i}')
        bias = getattr(lstm, f'bias_ih_l{i}') + getattr(lstm, f'bias_hh_l{i}')
        gates_x = _dense(x, w_ih, dtype=dtype)              # [B, T, 4H]
        c = h = x.new_zeros((x.shape[0], h_size), dtype=torch.float32)
        outs = []
        for t in range(x.shape[1]):
            gates = _dense(h, w_hh, bias, dtype) + gates_x[:, t]
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def gru_steps(gru: nn.GRU, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``gru`` (batch first, gate order r, z, n) over ``x [B, T, in]`` at
    ``dtype`` as flax's ``GRUCell(dtype=...)`` steps: the input and
    recurrent products, their biases and the gates in ``dtype``, the hidden
    state float32.  Returns the last layer's outputs ``[B, T, H]``
    float32."""
    h_size = gru.hidden_size
    for i in range(gru.num_layers):
        gates_x = _dense(x, getattr(gru, f'weight_ih_l{i}'),
                         getattr(gru, f'bias_ih_l{i}'), dtype)  # [B, T, 3H]
        w_hh = getattr(gru, f'weight_hh_l{i}')
        b_hh = getattr(gru, f'bias_hh_l{i}')
        h = x.new_zeros((x.shape[0], h_size), dtype=torch.float32)
        outs = []
        for t in range(x.shape[1]):
            xr, xz, xn = gates_x[:, t].chunk(3, dim=-1)
            hr, hz, hn = _dense(h, w_hh, b_hh, dtype).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def ge2e_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise embeddings along the last axis."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class GE2ESpeakerEncoder(nn.Module, ComputesAt):
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
        lstm = self.layer_Dict['LSTM']
        projection = self.layer_Dict['Projection']
        if self.dtype == torch.float32:
            with cudnn_float32():
                x, _ = lstm(mel_slices)
            return ge2e_normalize(projection(x[:, -1]))
        x = lstm_steps(lstm, mel_slices, self.dtype)
        return ge2e_normalize(_dense(x[:, -1], projection.weight,
                                     projection.bias, self.dtype))

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


class GSTProsodyEncoder(nn.Module, ComputesAt):
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
            conv = layers[f'Conv_{i}'].Conv
            if self.dtype == torch.float32:
                x = F.relu(conv_float32(x, conv.weight, None, conv.stride,
                                        conv.padding))     # [B, C, F, T']
            else:
                x = F.relu(F.conv2d(x.to(self.dtype),
                                    conv.weight.to(self.dtype), None,
                                    conv.stride, conv.padding))
        b, c, f, t = x.shape
        # channel-major flatten of (chan, freq) at each step
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * f)
        x = gru_steps(layers['GRU'], x, self.dtype)
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
        # float32 at any compute dtype: the JAX classifier has no dtype
        x = gradient_reversal(prosody, self.weight).float()
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
