"""Normalizing-flow mel decoder: squeeze → [ActNorm → invertible 1×1 →
WaveNet affine coupling] × K → unsqueeze (port of
``glow_tts_tpu/models/decoder.py``, ActNorm's data-dependent
initialisation included).

Deterministic (serving, evaluation), by ``config.coupling_backend``:
``'fused'`` (also ``'auto'``) runs each flow step as one call of
``ops.coupling.flow_step``; ``'mega'`` runs the whole stack as one call of
``ops.coupling.flow_stack`` on weights stacked over the steps; ``'modules'``
runs ActNorm, the invertible 1×1 and the coupling as three modules per
step, the coupling through ``ops.coupling.coupling``.  Each of the three is
a CUDA kernel on the card and its plain version on the CPU.  The modules
here hold the reference's parameters under its state-dict names;
:meth:`FlowStep.pack` turns them, without gradients, into the kernels'
weight dict (``glow_tts_tpu/models/decoder.py::FlowStep._fused_params``).

The conditioned modes (SE, PE, GR) add to each WaveNet layer's pre-gate
sum a per-sample row, ``speaker·W_spk + b_spk + prosody·W_pro + b_pro +
b_pitch`` beside the in-conv bias, and in GR mode the per-frame pitch term
``pitch·W_pitch``, which the kernels take as their pitch operand.  The rows
of all flow steps are built per call from weights kept until the
parameters change (:meth:`FlowDecoder.conditioning`), as
``glow_tts_tpu/models/decoder.py::AffineCoupling._gather`` builds them.

Training (``deterministic=False``): the whole stack runs as one call of
``ops.coupling_grad.flow_stack_train`` (forward and hand-written backward
kernels on the card) on weights that :meth:`FlowDecoder.pack_train` stacks
over the flow steps *with* autograd through weight norm, the 4×4 mixing
weight and ActNorm (``FlowDecoder._mega_train`` there).  In the
conditioned modes the train kernels add the in-conv bias themselves,
before the dropout, and the rows after it: so the train route's rows
(:meth:`FlowDecoder.train_conditioning`, built with autograd at every
call) carry the speaker and prosody products, their biases and ``b_pitch``,
never ``b_in``; GR mode's ``w_pitch`` rides in the packed weights.

The compute dtype is the decoder's ``dtype`` (``models/layers.py``).  At
bfloat16 each step computes as the TPU kernels do at ``dt = bfloat16``
(``ops/coupling.py``, ``ops/coupling_grad.py``), each kernel with a
bfloat16 build: training through ``flow_stack_train``, the deterministic
routes through ``flow_step`` (``'fused'``) and ``flow_stack``
(``'mega'``), the flow's stream between the steps bfloat16, as the JAX
package's kernel routes carry it.  ``'modules'`` is the JAX package's
flax route: its stream stays in the decoder input's dtype (float32 from
the train and eval steps' mels, bfloat16 from a decode's latent), ActNorm
applies its bfloat16-cast statistics to it, the invertible 1×1 mixes at
the stream's dtype, and ``coupling`` takes the halves cast to bfloat16 and
gives ``z_b`` back in the stream's dtype.  ActNorm's
statistics are float32 and its data-dependent initialisation reads each
step's own input, step by step through ``flow_step`` under every route;
the logdets are float32 and ``z`` leaves the decoder in float32.  A step
packs its weights per dtype (on a card the bfloat16 pack carries
``w_in``/``w_rs`` in the bfloat16 kernels' layout and the weights they
take rounded), and the decoder stacks them per direction and dtype for
``'mega'``.

Under tensor parallelism (:meth:`FlowDecoder.shard`, ``parallel/tp.py``)
every route, deterministic and train, resolves to the plain stack
(``ops.coupling.flow_stack_reference``, the train route
``ops.coupling_grad.flow_stack_train_reference``) with the WaveNet's
hidden stream sharded over the model group, as the JAX package's gates
resolve every backend to flax under a ``model`` axis (the flow kernels see
whole weights only).  Its weights are the same packs, of this rank's
slices: ``w_start [C/2, ch/M]`` and ``w_in [n, k, ch/M, 2ch]``, whose
weight norm sums its squares over the group.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from glow_tts_tpu_torch.models.layers import (
    ComputesAt, Conv1d, WNConv1d, masked, stacked_effective_weights)
from glow_tts_tpu_torch.ops.coupling import (COUPLING_PACK_KEYS, PAD_KEYS,
                                             RING_HALF_BIG, TC_KEYS,
                                             coupling, flow_stack,
                                             flow_stack_reference, flow_step,
                                             flow_step_reference, padded_key,
                                             padded_weights, ring_weights,
                                             rounded_weights,
                                             with_kernel_weights,
                                             with_tensor_core_weights)
from glow_tts_tpu_torch.ops.coupling_grad import (flow_stack_train,
                                                  flow_stack_train_reference)
from glow_tts_tpu_torch.ops.precision import rounded

logger = logging.getLogger(__name__)

FlowStepFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]
FlowStackFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def frames(mask: torch.Tensor) -> torch.Tensor:
    """Valid frames per sample, ``[B]`` float32, of ``mask [B, T, 1]``."""
    return mask.float().sum(dim=(1, 2))


def squeeze(x: torch.Tensor, mask: torch.Tensor, num_squeeze: int):
    """[B, T, C] → [B, T//s, s·C], time truncated to a multiple of s; the
    squeezed mask is the mask of each group's last frame."""
    b, t, c = x.shape
    t = (t // num_squeeze) * num_squeeze
    x = x[:, :t].reshape(b, t // num_squeeze, num_squeeze * c)
    mask = mask[:, num_squeeze - 1:t:num_squeeze].contiguous()
    return masked(x, mask), mask


def unsqueeze(x: torch.Tensor, mask: torch.Tensor, num_squeeze: int):
    """Inverse of :func:`squeeze`."""
    b, t, c = x.shape
    x = x.reshape(b, t * num_squeeze, c // num_squeeze)
    mask = mask.repeat_interleave(num_squeeze, dim=1)
    return masked(x, mask), mask


class ActNorm(nn.Module):
    """Per-channel affine; parameters ``[1, C, 1]`` as in the reference."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    @torch.no_grad()
    def data_dependent_init(self, x: torch.Tensor,
                            mask: torch.Tensor) -> None:
        """Set ``logs``/``bias`` so that this layer's output has zero mean
        and unit variance per channel over the valid frames of
        ``x [B, T, C]`` (``mask [B, T, 1]``): ``logs = −log σ``,
        ``bias = −mean·exp(logs)``, the variance clipped at 1e-7."""
        x, mask = x.float(), mask.float()
        denom = mask.sum().clamp_min(1.0)
        mean = (x * mask).sum(dim=(0, 1)) / denom
        var = (x * x * mask).sum(dim=(0, 1)) / denom - mean ** 2
        log_std = 0.5 * torch.log(var.clamp_min(1e-7))
        self.logs.copy_((-log_std).reshape(1, -1, 1))
        self.bias.copy_((-mean * torch.exp(-log_std)).reshape(1, -1, 1))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False, dtype: Optional[torch.dtype] = None):
        """``x [B, T, C]``, ``mask [B, T, 1]`` → ``(z, logdet [B] | None)``:
        ``(bias + exp(logs)·x)·mask`` and its inverse at the compute
        ``dtype`` (default ``x``'s): at bfloat16 the float32 statistics are
        cast to it and applied to ``x`` in the wider of the two dtypes, as
        the JAX package's ``ActNorm`` promotes them; the logdet float32."""
        logs, bias = self.logs.reshape(-1), self.bias.reshape(-1)
        dt = dtype or x.dtype
        if dt != torch.float32:
            if reverse:
                return masked((x - bias.to(dt)) * torch.exp(-logs).to(dt),
                              mask), None
            return (masked(bias.to(dt) + torch.exp(logs).to(dt) * x, mask),
                    logs.float().sum() * frames(mask))
        if reverse:
            return masked((x - bias) * torch.exp(-logs), mask), None
        return (masked(bias + torch.exp(logs) * x, mask),
                logs.float().sum() * frames(mask))


def mixing_products(weight: torch.Tensor, one_hot: torch.Tensor,
                    same_member: torch.Tensor) -> torch.Tensor:
    """``weight [..., s, s]`` → the block-sparse ``[..., C, C]`` mixing
    G·W·Gᵀ masked by ``same_member [C, C]``, where ``one_hot [C, s]`` is G.
    Each entry sums one product by 1.0 and zeros, so the values are the
    weight's bit for bit, as an index gather would give; unlike a gather's
    backward (an indexed accumulation), the weight's gradient is a fixed
    sum of products, the same in every run.  Written as broadcast products
    and sums, not matmuls, so no TF32 setting rounds the weight."""
    rows = (one_hot[:, :, None] * weight[..., None, :, :]).sum(-2)  # [.., C, s]
    return (rows[..., :, None, :] * one_hot[None, :, :]).sum(-1) * same_member


class InvertibleConv(nn.Module):
    """Invertible 1×1 conv over ``num_split`` interleaved channel groups.

    The ``s × s`` weight acts on channel c = (a, m, b') through group
    g = (a, b'); over all C channels that is the block-sparse matrix
    M[i, j] = W[g(i), g(j)]·[m(i) = m(j)], built here as the one-hot
    products G·W·Gᵀ (:func:`mixing_products`)."""

    def __init__(self, channels: int, num_split: int):
        super().__init__()
        assert num_split % 2 == 0 and channels % num_split == 0
        self.num_split = num_split
        self.weight = nn.Parameter(torch.empty(num_split, num_split))
        half, s2 = channels // 2, num_split // 2
        idx = np.arange(channels)
        rem = idx % half
        # buffers, so they move with the module (not in the state dict)
        group = (idx // half) * s2 + rem % s2
        member = rem // s2
        # buffers, so they move with the module (not in the state dict):
        # the one-hot of each channel's group, and the member equality
        self.register_buffer(
            '_one_hot', torch.as_tensor(
                (group[:, None] == np.arange(num_split)[None, :]),
                dtype=torch.float32), persistent=False)
        self.register_buffer(
            '_same_member', torch.as_tensor(
                member[:, None] == member[None, :], dtype=torch.float32),
            persistent=False)

    def mixing_matrix(self, inverse: bool = False) -> torch.Tensor:
        """[C_out, C_in] channel mixing (of W⁻¹ when ``inverse``)."""
        w = torch.linalg.inv(self.weight) if inverse else self.weight
        return mixing_products(w, self._one_hot, self._same_member)

    def frame_logdet(self, channels: int) -> torch.Tensor:
        """log |det| of the mixing per valid frame: the weight's, once for
        each of the ``channels / num_split`` groups it acts on."""
        return (torch.linalg.slogdet(self.weight)[1]
                * (channels / self.num_split))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False,
                packed: Optional[Tuple[torch.Tensor,
                                       Optional[torch.Tensor]]] = None):
        """``x [B, T, C]``, ``mask [B, T, 1]`` → ``(z, logdet [B] | None)``:
        the channel mixing as one ``[C, C]`` product, by W⁻¹ on the inverse
        pass.  ``packed`` is ``(mix_t [C_in, C_out], frame_logdet)`` of this
        direction where a caller keeps them; without it both are computed
        from the weight now."""
        if packed is None:
            packed = (self.mixing_matrix(inverse=reverse).t(),
                      None if reverse else self.frame_logdet(x.shape[-1]))
        mix_t, frame_logdet = packed
        if x.dtype == torch.float32:
            z = x @ mix_t
        else:
            # float32 sums of the mixing cast to x's dtype, cast back
            z = (x.float() @ rounded(mix_t, x.dtype)).to(x.dtype)
        z = masked(z, mask)
        return z, (None if reverse else frame_logdet * frames(mask))


# the conditioning 1x1 convs of a WaveNet layer: (module name, key of the
# packed weights); a mode has those whose input width is not 0
CONDITIONING = (('Speaker', 'spk'), ('Prosody', 'pro'), ('Pitch', 'pitch'))


class WaveNet(nn.Module):
    """The coupling's gated layers; ``widths`` gives the input width of
    each conditioning conv of :data:`CONDITIONING` the mode has."""

    def __init__(self, channels: int, num_layers: int, kernel_size: int,
                 widths: Optional[Dict[str, int]] = None):
        super().__init__()
        self.num_layers = num_layers
        self.conditioning = [(name, key) for name, key in CONDITIONING
                             if (widths or {}).get(name)]
        self.layer_Dict = nn.ModuleDict()
        for i in range(num_layers):
            last = i == num_layers - 1
            self.layer_Dict[f'In_{i}'] = WNConv1d(
                channels, 2 * channels, kernel_size)
            self.layer_Dict[f'Res_Skip_{i}'] = WNConv1d(
                channels, channels if last else 2 * channels, 1)
            for name, _ in self.conditioning:
                self.layer_Dict[f'{name}_{i}'] = WNConv1d(
                    widths[name], 2 * channels, 1)


class AffineCoupling(nn.Module):
    def __init__(self, config):
        super().__init__()
        cfg = config.decoder.affine_coupling
        c = config.sound.mel_dim * config.decoder.num_squeeze
        ch = cfg.calc_channels
        widths = {
            'Speaker': (config.speaker_embedding.embedding_size
                        if config.uses_speaker_embedding else 0),
            'Prosody': (config.prosody_encoder.size
                        if config.uses_prosody_encoder else 0),
            'Pitch': (config.decoder.num_squeeze
                      if config.uses_gradient_reversal else 0)}
        self.layer_Dict = nn.ModuleDict({
            'Start': WNConv1d(c // 2, ch, 1),
            'WaveNet': WaveNet(ch, cfg.wavenet.num_layers,
                               cfg.wavenet.kernel_size, widths),
            'End': Conv1d(ch, c, 1)})

    def pack(self) -> Tuple[Dict[str, torch.Tensor],
                            Dict[str, torch.Tensor]]:
        """Effective coupling weights in the kernel's layout (with
        ``w_pitch [n, ps, 2ch]`` in GR mode), and the weights the per-layer
        conditioning rows are made of: ``b_in [n, 2ch]`` (all a Vanilla row
        is) and, by mode, ``w_spk``/``w_pro [n, E, 2ch]``, ``b_spk``,
        ``b_pro`` and ``b_pitch [n, 2ch]``."""
        layers = self.layer_Dict
        wn = layers['WaveNet']
        w_in, b_in, w_rs, b_rs = [], [], [], []
        conditioning = {f'{prefix}_{key}': [] for _, key in wn.conditioning
                        for prefix in ('w', 'b')}
        for i in range(wn.num_layers):
            for name, key in wn.conditioning:
                conv = wn.layer_Dict[f'{name}_{i}']
                conditioning[f'w_{key}'].append(
                    conv.effective_weight()[:, :, 0].t())       # [in, 2ch]
                conditioning[f'b_{key}'].append(conv.bias)
            conv = wn.layer_Dict[f'In_{i}']
            w_in.append(conv.effective_weight().permute(2, 1, 0))  # [k,ch,2ch]
            b_in.append(conv.bias)
            res_skip = wn.layer_Dict[f'Res_Skip_{i}']
            w = res_skip.effective_weight()[:, :, 0].t()
            bias = res_skip.bias
            if i == wn.num_layers - 1:
                # uniform [ch, 2ch]: the last layer feeds the skip half only
                w = torch.cat([torch.zeros_like(w), w], dim=1)
                bias = torch.cat([torch.zeros_like(bias), bias])
            w_rs.append(w)
            b_rs.append(bias)
        start = layers['Start']
        weights = {
            'w_start': start.effective_weight()[:, :, 0].t(),
            'b_start': start.bias,
            'w_in': torch.stack(w_in), 'w_rs': torch.stack(w_rs),
            'b_rs': torch.stack(b_rs),
            'w_end': layers['End'].weight[:, :, 0].t(),
            'b_end': layers['End'].bias,
        }
        conditioning = {key: torch.stack(value)
                        for key, value in conditioning.items()}
        if 'w_pitch' in conditioning:
            weights['w_pitch'] = conditioning.pop('w_pitch')
        return weights, {'b_in': torch.stack(b_in), **conditioning}

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False, coupling_fn: FlowStepFn = coupling,
                packed: Optional[Tuple[Dict[str, torch.Tensor],
                                       torch.Tensor]] = None,
                pitch: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None):
        """``x [B, T, C]``, ``mask [B, T, 1]`` → ``(z, logdet [B] | None)``:
        ``x_a`` passes, ``x_b`` goes through ``coupling_fn`` (the kernel's
        wrapper unless a caller compares it with the plain version) at the
        compute ``dtype`` (default ``x``'s: the halves go in cast to it and
        ``z_b`` comes back in ``x``'s dtype, as the JAX package's fused
        coupling branch casts them) on ``packed``, the contiguous float32
        ``(weights, cond [n, B, 2ch])`` a caller keeps, or on this module's
        weights packed now, without gradients, for the kernels of ``dtype``
        (on the card with their tensor-core layout, at bfloat16 the ring
        body's slices; at bfloat16 the weights they take rounded, as
        :meth:`FlowStep.weights` packs them), with the Vanilla rows.
        ``pitch [B, T, ps]`` is GR mode's pitch operand."""
        dt = dtype or x.dtype
        if packed is None:
            with torch.no_grad():
                weights, rows = self.pack()
                b_in = rows['b_in']
                weights = {key: value.float().contiguous()
                           for key, value in weights.items()}
                weights = (with_kernel_weights(weights, dt)
                           if x.device.type == 'cuda'
                           else rounded_weights(weights, dt))
                n, ch2 = b_in.shape
                cond = b_in.float()[:, None, :].expand(
                    n, x.shape[0], ch2).contiguous()
        else:
            weights, cond = packed
        c2 = x.shape[-1] // 2
        xc = x.to(dt)
        z_b, logdet = coupling_fn(xc[..., :c2], xc[..., c2:], mask, weights,
                                  cond, pitch=pitch, reverse=reverse)
        return torch.cat([x[..., :c2], z_b.to(x.dtype)], dim=-1), logdet


class FlowStep(nn.Module):
    """ActNorm → invertible 1×1 → affine coupling (reverse order on the
    inverse pass): as one ``flow_step`` call on weights packed by
    :meth:`pack`, or, on the ``'modules'`` route, module by module."""

    # the world of the model group its coupling is sharded over (None:
    # whole), set by FlowDecoder.shard
    tp = None

    def __init__(self, config):
        super().__init__()
        c = config.sound.mel_dim * config.decoder.num_squeeze
        self.modules_route = config.flow_route == 'modules'
        self.layers = nn.ModuleList([
            ActNorm(c), InvertibleConv(c, config.decoder.num_split),
            AffineCoupling(config)])
        self._packed: Optional[Dict[bool, Dict[str, torch.Tensor]]] = None
        # the packs of the other dtypes' kernels (bfloat16): the float32
        # pack with the weights they take rounded and, on a card, the ring
        # body's slices
        self._by_dtype: Dict[torch.dtype,
                             Dict[bool, Dict[str, torch.Tensor]]] = {}
        self._rows: Optional[Dict[str, torch.Tensor]] = None
        self._mix_logdet: Optional[torch.Tensor] = None

    @torch.no_grad()
    def pack(self) -> None:
        """Build both directions' kernel weights from the current
        parameters, on their device (on a card with ``w_in`` and ``w_rs``
        also in the float32 kernels' tensor-core layout; the bfloat16 pack is
        made from this one at its first use).  Call again after loading
        weights."""
        self._by_dtype = {}
        actnorm, invconv, coupling = self.layers
        weights, rows = coupling.pack()
        self._rows = {key: value.detach().float().contiguous()
                      for key, value in rows.items()}
        c = actnorm.logs.shape[1]
        logs = actnorm.logs.reshape(c)
        common = {**weights, 'an_logs': logs,
                  'an_bias': actnorm.bias.reshape(c)}
        self._mix_logdet = invconv.frame_logdet(c).detach().float()
        packed = {
            False: {**common, 'mix_t': invconv.mixing_matrix().t(),
                    'ld_const': logs.sum() + self._mix_logdet},
            True: {**common,
                   'mix_t': invconv.mixing_matrix(inverse=True).t()},
        }
        # plain contiguous float32 tensors, as the kernel takes them
        self._packed = {
            direction: {key: value.detach().float().contiguous()
                        for key, value in weights.items()}
            for direction, weights in packed.items()}
        if logs.device.type == 'cuda' and self.tp is None:
            # w_in and w_rs split into TF32 halves in the kernels' layout
            # and, at a WaveNet width off the float32 body's grain, the
            # padded copies it reads, once per pack (both directions share
            # them)
            split = {key: value for key, value in with_tensor_core_weights(
                self._packed[False]).items()
                if key in TC_KEYS.values() or key in self._padded}
            for weights in self._packed.values():
                weights.update(split)

    # the names of the padded copies a pack may carry (ops/coupling.py's
    # padded_weights), each body's own
    _padded = tuple(padded_key(key) for key in PAD_KEYS)

    def invalidate(self) -> None:
        """Forget the packed weights: the parameters have changed."""
        self._packed = self._mix_logdet = self._rows = None
        self._by_dtype = {}

    def rows(self) -> Dict[str, torch.Tensor]:
        """The weights of the per-layer conditioning rows
        (:meth:`AffineCoupling.pack`), detached float32."""
        if self._rows is None:
            self.pack()
        return self._rows

    def weights(self, reverse: bool,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """The packed weights of one direction for the kernels of
        ``dtype``, packed now if the parameters changed since
        (:meth:`invalidate`)."""
        if self._packed is None:
            self.pack()
        if dtype == torch.float32:
            return self._packed[reverse]
        if dtype not in self._by_dtype:
            packs = self._packed
            rings = {direction: {} for direction in packs}
            if packs[False]['an_logs'].device.type == 'cuda':
                # the ring body's slices (the bfloat16 flow_step, coupling
                # and flow_stack) and the copies it reads at its WaveNet
                # width: both directions share all but the mixing's
                common = {**ring_weights({key: packs[False][key] for key in (
                    'w_start', 'w_in', 'w_rs', 'w_end')}),
                    **padded_weights(packs[False], RING_HALF_BIG)}
                rings = {direction: {**common, **ring_weights(
                    {'mix_t': weights['mix_t']})}
                    for direction, weights in packs.items()}
            # without the float32 tensor-core layout and padded copies,
            # which no bfloat16 build reads
            self._by_dtype[dtype] = {
                direction: rounded_weights(
                    {**{key: value for key, value in weights.items()
                        if key not in TC_KEYS.values()
                        and key not in self._padded},
                     **rings[direction]},
                    dtype)
                for direction, weights in packs.items()}
        return self._by_dtype[dtype][reverse]

    def cond(self, batch: int) -> torch.Tensor:
        """Per-layer, per-sample bias ``[n, B, 2ch]`` of an unconditioned
        pass: the in-conv bias alone."""
        b_in = self.rows()['b_in']
        n, ch2 = b_in.shape
        return b_in[:, None, :].expand(n, batch, ch2).contiguous()

    def forward(self, x, mask, reverse: bool = False,
                step_fn: FlowStepFn = flow_step,
                coupling_fn: FlowStepFn = coupling,
                cond: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None):
        """→ ``(z, logdet [B] | None)``.  ``step_fn`` and ``coupling_fn``
        are the kernels' wrappers unless a caller compares them with the
        plain versions; the route decides which of the two runs.  ``cond
        [n, B, 2ch]`` is this step's conditioning rows (default: the
        unconditioned :meth:`cond`), ``pitch [B, T, ps]`` GR mode's pitch
        operand.  ``dtype`` is the compute dtype (default ``x``'s): under
        ``'modules'`` the stream stays in ``x``'s dtype between the three
        modules, ActNorm and the coupling compute at ``dtype`` and the
        mixing at the stream's, as the JAX package's flax modules do."""
        if cond is None:
            cond = self.cond(x.shape[0])
        if not self.modules_route:
            return step_fn(x, mask, self.weights(reverse, x.dtype), cond,
                           reverse, pitch=pitch)
        dt = dtype or x.dtype
        actnorm, invconv, coupling_module = self.layers
        weights = self.weights(reverse, dt)
        packed = ({key: weights[key] for key in COUPLING_PACK_KEYS
                   if key in weights}, cond)
        mixing = (self.weights(reverse, x.dtype)['mix_t'], self._mix_logdet)
        if reverse:
            x, _ = coupling_module(x, mask, True, coupling_fn, packed, pitch,
                                   dt)
            x, _ = invconv(x, mask, True, mixing)
            return actnorm(x, mask, True, dt)
        x, logdet = actnorm(x, mask, dtype=dt)
        x, ld = invconv(x, mask, False, mixing)
        logdet = logdet + ld
        x, ld = coupling_module(x, mask, False, coupling_fn, packed, pitch,
                                dt)
        return x, logdet + ld


# the process logs once that the sharded stack takes every route
_TP_LOGGED: list = []


class FlowDecoder(nn.Module, ComputesAt):
    """mels ↔ latents.  Forward returns the summed log-determinant;
    reverse runs the steps backwards."""

    # the world of the model group the couplings are sharded over (None:
    # whole), set by :meth:`shard`
    tp = None

    def __init__(self, config):
        super().__init__()
        self.num_squeeze = config.decoder.num_squeeze
        self.dropout_rate = config.decoder.affine_coupling.wavenet.dropout_rate
        self.mega_route = config.flow_route == 'mega'
        self.modules_route = config.flow_route == 'modules'
        self.layer_Dict = nn.ModuleDict({'Flows': nn.ModuleList([
            FlowStep(config) for _ in range(config.decoder.stack)])})
        self._stacked: Dict[Tuple[bool, torch.dtype],
                            Dict[str, torch.Tensor]] = {}
        self._stacked_cond: Optional[torch.Tensor] = None
        self._stacked_rows: Optional[Dict[str, torch.Tensor]] = None

    def pack(self) -> None:
        self.invalidate()
        for step in self.layer_Dict['Flows']:
            step.pack()

    def shard(self, world) -> None:
        """Run every coupling with its WaveNet's hidden stream sharded over
        ``world``'s model group, on this rank's slices of ``Start``
        (column-parallel) and of each ``In_i`` (row-parallel, its weight
        norm summed over the group): every route resolves to the plain
        stack sharded over ``world``."""
        self.tp = world
        for step in self.layer_Dict['Flows']:
            step.tp = world
            wavenet = step.layers[2].layer_Dict['WaveNet']
            for i in range(wavenet.num_layers):
                wavenet.layer_Dict[f'In_{i}'].norm_over = world
        self.invalidate()
        if not _TP_LOGGED:
            _TP_LOGGED.append(True)
            logger.info('tensor parallel over model=%d: every coupling '
                        'route runs the plain stack (no flow kernel)',
                        world.model_size)

    def invalidate(self) -> None:
        """Call after the parameters changed (an optimiser update): the
        deterministic path packs again at its next use."""
        self._stacked, self._stacked_cond, self._stacked_rows = {}, None, None
        for step in self.layer_Dict['Flows']:
            step.invalidate()

    def stacked_weights(self, reverse: bool,
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
        """The packed weights of one direction of every step for the
        kernels of ``dtype`` (:meth:`FlowStep.weights`), stacked along a
        leading flow axis in forward order, as ``flow_stack`` takes them
        (``glow_tts_tpu/models/decoder.py::FlowDecoder._mega``); stacked
        once per direction and dtype and kept until the parameters
        change."""
        key = (reverse, dtype)
        if key not in self._stacked:
            packs = [step.weights(reverse, dtype)
                     for step in self.layer_Dict['Flows']]
            self._stacked[key] = {
                name: torch.stack([pack[name] for pack in packs])
                for name in packs[0]}
        return self._stacked[key]

    def stacked_cond(self, batch: int) -> torch.Tensor:
        """Per-step, per-layer, per-sample bias ``[S, n, B, 2ch]`` of an
        unconditioned pass: the in-conv biases alone."""
        if self._stacked_cond is None:
            self._stacked_cond = torch.stack(
                [step.cond(1)[:, 0] for step in self.layer_Dict['Flows']])
        s, n, ch2 = self._stacked_cond.shape
        return self._stacked_cond[:, :, None, :].expand(
            s, n, batch, ch2).contiguous()

    def conditioning(self, batch: int,
                     speaker: Optional[torch.Tensor] = None,
                     prosody: Optional[torch.Tensor] = None,
                     pitch: bool = False) -> torch.Tensor:
        """The conditioning rows of every flow step, layer and sample,
        ``[S, n, B, 2ch]``: the in-conv bias, plus ``speaker [B, E]·W_spk +
        b_spk``, ``prosody [B, P]·W_pro + b_pro`` and, when a pitch operand
        goes with them, ``b_pitch``.  The weights are stacked over the steps
        once and kept until the parameters change; the rows depend on the
        batch and are built at every call, one product per conditioning
        vector for all the steps."""
        if speaker is None and prosody is None and not pitch:
            return self.stacked_cond(batch)
        if self._stacked_rows is None:
            rows = [step.rows() for step in self.layer_Dict['Flows']]
            self._stacked_rows = {key: torch.stack([r[key] for r in rows])
                                  for key in rows[0]}
        w = self._stacked_rows
        bias = w['b_in']                                    # [S, n, 2ch]
        for vector, key in ((speaker, 'spk'), (prosody, 'pro')):
            if vector is not None:
                bias = bias + w[f'b_{key}']
        if pitch:
            bias = bias + w['b_pitch']
        s, n, ch2 = bias.shape
        cond = bias[:, :, None, :].expand(s, n, batch, ch2)
        for vector, key in ((speaker, 'spk'), (prosody, 'pro')):
            if vector is not None:
                cond = cond + torch.einsum('be,snec->snbc', vector.float(),
                                           w[f'w_{key}'])
        return cond.contiguous()

    def _wavenets(self) -> list:
        return [step.layers[2].layer_Dict['WaveNet']
                for step in self.layer_Dict['Flows']]

    def _stacked_layer_convs(self, name: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 1×1 convs ``<name>_<i>`` of every step and layer, stacked with
        autograd through weight norm: ``[S, n, in, out]`` in the kernels'
        layout and their biases ``[S, n, out]``."""
        wavenets = self._wavenets()
        n = wavenets[0].num_layers
        w, b = stacked_effective_weights([wn.layer_Dict[f'{name}_{i}']
                                          for wn in wavenets
                                          for i in range(n)])
        s, out, width, _ = w.shape[0] // n, *w.shape[1:]
        return (w[..., 0].transpose(1, 2).reshape(s, n, width, out),
                b.reshape(s, n, out))

    def train_conditioning(self, batch: int,
                           speaker: Optional[torch.Tensor] = None,
                           prosody: Optional[torch.Tensor] = None,
                           pitch: bool = False) -> Optional[torch.Tensor]:
        """The train route's conditioning rows ``[S, n, B, 2ch]``, added
        after the dropout: ``speaker [B, E]·W_spk + b_spk``, ``prosody
        [B, P]·W_pro + b_pro`` and, when a pitch operand goes with them,
        ``b_pitch``; without the in-conv bias, which the train kernels add
        before the dropout.  Built at every call with autograd down to the
        parameters (``glow_tts_tpu/models/decoder.py::AffineCoupling.
        _gather`` with ``split_bias``); None in Vanilla mode."""
        if speaker is None and prosody is None and not pitch:
            return None
        rows = None
        for vector, name in ((speaker, 'Speaker'), (prosody, 'Prosody')):
            if vector is not None:
                w, b = self._stacked_layer_convs(name)
                term = (torch.einsum('be,snec->snbc', vector.float(), w)
                        + b[:, :, None, :])
                rows = term if rows is None else rows + term
        if pitch:
            b = torch.stack([torch.stack([
                wn.layer_Dict[f'Pitch_{i}'].bias
                for i in range(wn.num_layers)]) for wn in self._wavenets()])
            rows = (b[:, :, None, :] if rows is None
                    else rows + b[:, :, None, :])
        s, n, _, ch2 = rows.shape
        return rows.float().expand(s, n, batch, ch2).contiguous()

    def pack_train(self) -> Dict[str, torch.Tensor]:
        """The forward weights of every step in the train kernels' layout,
        stacked along a leading flow axis (``ops.coupling_grad.
        weight_shapes``, ``b_in`` under its own key, plus ``ld_const
        [S]`` and in GR mode ``w_pitch [S, n, ps, 2ch]``), contiguous
        float32, with autograd through weight norm, the mixing weight and
        ActNorm down to the parameters.  Each kind of tensor is computed for
        all steps at once: a few dozen launches instead of a few dozen per
        step."""
        steps = list(self.layer_Dict['Flows'])
        actnorms, invconvs, couplings = zip(*(step.layers for step in steps))
        wavenets = [c.layer_Dict['WaveNet'] for c in couplings]
        n = wavenets[0].num_layers

        def conv(name):
            return stacked_effective_weights(
                [wn.layer_Dict[name] for wn in wavenets])

        w_in, b_in, w_rs, b_rs = [], [], [], []
        for i in range(n):
            w, b = conv(f'In_{i}')                       # [S, 2ch, ch, k]
            w_in.append(w.permute(0, 3, 2, 1))           # [S, k, ch, 2ch]
            b_in.append(b)
            w, b = conv(f'Res_Skip_{i}')
            w = w[..., 0].transpose(1, 2)                # [S, ch, 2ch | ch]
            if i == n - 1:
                # uniform [ch, 2ch]: the last layer feeds the skip half only
                w = torch.cat([torch.zeros_like(w), w], dim=2)
                b = torch.cat([torch.zeros_like(b), b], dim=1)
            w_rs.append(w)
            b_rs.append(b)
        w_start, b_start = stacked_effective_weights(
            [c.layer_Dict['Start'] for c in couplings])
        ends = [c.layer_Dict['End'] for c in couplings]

        c = actnorms[0].logs.shape[1]
        logs = torch.stack([a.logs.reshape(c) for a in actnorms])
        mix_w = torch.stack([inv.weight for inv in invconvs])    # [S, s, s]
        mixing = mixing_products(mix_w, invconvs[0]._one_hot,
                                 invconvs[0]._same_member)      # [S, out, in]
        logabsdet = torch.linalg.slogdet(mix_w)[1]
        weights = {
            'an_logs': logs,
            'an_bias': torch.stack([a.bias.reshape(c) for a in actnorms]),
            'mix_t': mixing.transpose(1, 2),
            'w_start': w_start[..., 0].transpose(1, 2), 'b_start': b_start,
            'w_in': torch.stack(w_in, dim=1), 'b_in': torch.stack(b_in, dim=1),
            'w_rs': torch.stack(w_rs, dim=1), 'b_rs': torch.stack(b_rs, dim=1),
            'w_end': torch.stack([e.weight[:, :, 0] for e in ends]
                                 ).transpose(1, 2),
            'b_end': torch.stack([e.bias for e in ends]),
            'ld_const': (logs.sum(dim=1)
                         + logabsdet * (c / invconvs[0].num_split)),
        }
        if ('Pitch', 'pitch') in wavenets[0].conditioning:
            weights['w_pitch'] = self._stacked_layer_convs('Pitch')[0]
        return {key: value.float().contiguous()
                for key, value in weights.items()}

    def _squeezed_pitch(self, pitch: Optional[torch.Tensor],
                        mask: torch.Tensor) -> Optional[torch.Tensor]:
        """``pitch [B, T]`` as the kernels' pitch operand ``[B, T/s, s]``."""
        if pitch is None:
            return None
        pitch, _ = squeeze(pitch[..., None].float(), mask, self.num_squeeze)
        return pitch.contiguous()

    @torch.no_grad()
    def data_dependent_init(self, x, mask,
                            step_fn: FlowStepFn = flow_step,
                            speaker: Optional[torch.Tensor] = None,
                            prosody: Optional[torch.Tensor] = None,
                            pitch: Optional[torch.Tensor] = None) -> None:
        """ActNorm's data-dependent initialisation on the batch
        ``x [B, T, M]``, ``mask [B, T, 1]`` and its conditioning (as
        :meth:`forward` takes it), step by step under every route: each
        step's statistics come from its own input, so a step is set,
        re-packed and run forward (through ``step_fn``, with the step's
        conditioning rows and the pitch operand) before the next one is
        set.  At bfloat16 the steps run at it (the first step's statistics
        come from the float32 mels, the others' from the bfloat16 stream)."""
        pitch = self._squeezed_pitch(pitch, mask)
        x, sq_mask = squeeze(x, mask, self.num_squeeze)
        pack_dtype = self.dtype
        if self.tp is not None:
            # the plain step, sharded, on the float32 pack
            pack_dtype = torch.float32

            def step_fn(x, mask, weights, cond, reverse, pitch=None):
                return flow_step_reference(x, mask, weights, cond, reverse,
                                           pitch, world=self.tp)
        self.invalidate()
        # the rows read the WaveNets' conditioning convs, which the init
        # does not change
        cond = self.conditioning(x.shape[0], speaker, prosody,
                                 pitch is not None)
        for k, step in enumerate(self.layer_Dict['Flows']):
            step.layers[0].data_dependent_init(x, sq_mask)
            step.pack()
            x, _ = step_fn(x.to(self.dtype), sq_mask,
                           step.weights(False, pack_dtype), cond[k], False,
                           pitch=pitch)

    def forward(self, x, mask, reverse: bool = False,
                step_fn: FlowStepFn = flow_step, deterministic: bool = True,
                seed: Optional[int] = None,
                stack_fn: FlowStackFn = flow_stack_train,
                coupling_fn: FlowStepFn = coupling,
                flow_stack_fn: FlowStepFn = flow_stack,
                speaker: Optional[torch.Tensor] = None,
                prosody: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None):
        """x [B, T, M]; mask [B, T, 1].  ``step_fn``, ``coupling_fn`` and
        ``flow_stack_fn`` (the deterministic routes' functions) and
        ``stack_fn`` (the train route's) are the kernels' wrappers unless a
        caller compares them with the plain versions.
        ``deterministic=False`` (forward only) is the differentiable train
        route with WaveNet dropout drawn from the int32 ``seed``.  The
        conditioned modes pass ``speaker [B, E]``, ``prosody [B, P]`` and
        (GR) ``pitch [B, T]``, which is squeezed to the kernels' pitch
        operand ``[B, T/s, s]``.  The flow computes at the decoder's dtype
        and returns x in float32; its stream between the steps is in that
        dtype too, except under ``'modules'``, where it stays in ``x``'s
        dtype as the JAX package's flax route carries it (float32 from
        the train and eval steps' mels, the serving dtype from a decode's
        latent).  Returns (x, logdet [B] or None, mask)."""
        s = self.num_squeeze
        pitch = self._squeezed_pitch(pitch, mask)
        x, sq_mask = squeeze(x, mask, s)
        if not (self.modules_route and deterministic) or self.tp is not None:
            x = x.to(self.dtype)
        if not deterministic and (reverse or seed is None):
            raise ValueError('the train route runs forward and needs a seed')
        if self.tp is not None:
            # every route: the plain stack, sharded
            if deterministic:
                cond = self.conditioning(x.shape[0], speaker, prosody,
                                         pitch is not None)
                x, logdet = flow_stack_reference(
                    x, sq_mask, self.stacked_weights(reverse), cond, pitch,
                    reverse, world=self.tp)
            else:
                cond = self.train_conditioning(x.shape[0], speaker, prosody,
                                               pitch is not None)
                x, logdet = flow_stack_train_reference(
                    x, sq_mask, self.pack_train(), cond, pitch, seed=seed,
                    dropout_rate=self.dropout_rate, world=self.tp)
        elif not deterministic:
            cond = self.train_conditioning(x.shape[0], speaker, prosody,
                                           pitch is not None)
            x, logdet = stack_fn(x, sq_mask, self.pack_train(), cond, pitch,
                                 seed=seed, dropout_rate=self.dropout_rate)
        else:
            cond = self.conditioning(x.shape[0], speaker, prosody,
                                     pitch is not None)
            if self.mega_route:
                x, logdet = flow_stack_fn(
                    x, sq_mask, self.stacked_weights(reverse, x.dtype), cond,
                    pitch=pitch, reverse=reverse)
            else:
                steps = list(enumerate(self.layer_Dict['Flows']))
                logdet = None if reverse else torch.zeros(
                    x.shape[0], device=x.device)
                for k, step in (reversed(steps) if reverse else steps):
                    x, ld = step(x, sq_mask, reverse, step_fn, coupling_fn,
                                 cond[k], pitch, self.dtype)
                    if ld is not None:
                        logdet = logdet + ld
        x, out_mask = unsqueeze(x.float(), sq_mask, s)
        return x, logdet, out_mask
