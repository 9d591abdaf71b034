"""Weights into the port, and gradients back out.

The port's modules carry the reference's state-dict names, so three
sources load the same way, with ``load_state_dict(strict=True)``:

* the reference's ``S_<step>.pt`` checkpoints, and the JAX package's
  ``save_reference_checkpoint`` output, which has the same payload;
* JAX parameters held as numpy arrays, renamed and re-laid-out by
  :func:`convert_params_to_reference`, this package's own copy of the
  name map of ``glow_tts_tpu/utils/torch_export.py`` (a CPU test holds the
  two equal bit for bit), in all four modes.

The reference loads the GE2E speaker encoder (SE mode with
``Speaker_Embedding.Type: GE2E``) from a checkpoint of its own, so a
reference state dict has no GE2E weights: the port keeps them under
``nn.LSTM``'s and ``nn.Linear``'s names below ``layer_Dict.GE2E``, and
:func:`load_state_dict` takes them from
``Speaker_Embedding.GE2E.Checkpoint_Path`` (:func:`load_ge2e_checkpoint`)
when the state dict lacks them.

:func:`reference_to_params` is the inverse map, from reference names and
layouts back to the JAX parameter tree.  The map is a renaming and
transposition, so it carries gradients as it carries values:
:func:`gradients_as_jax_params` lays the port's ``.grad`` out leaf by leaf
as ``jax.grad`` of the JAX model returns them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of an ``S_<step>.pt`` file."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    return payload['Model'] if 'Model' in payload else payload


GE2E_PREFIX = 'layer_Dict.GE2E.layer_Dict.'


def load_state_dict(model: nn.Module,
                    state_dict: Mapping[str, object]) -> nn.Module:
    """Load a reference-format state dict (tensors or numpy arrays).  A
    GE2E-mode model whose state dict has no GE2E weights takes them from
    ``config.speaker_embedding.ge2e.checkpoint_path``."""
    state_dict = dict(state_dict)
    config = getattr(model, 'config', None)
    if (config is not None and config.uses_ge2e
            and not any(key.startswith(GE2E_PREFIX) for key in state_dict)):
        path = config.speaker_embedding.ge2e.checkpoint_path
        if not path:
            raise KeyError(
                'the state dict has no GE2E weights (the reference keeps '
                'them in a checkpoint of their own): set '
                'Speaker_Embedding.GE2E.Checkpoint_Path')
        state_dict.update(load_ge2e_checkpoint(path, config))
    model.load_state_dict(
        {key: torch.as_tensor(np.ascontiguousarray(value))
         if isinstance(value, np.ndarray) else value
         for key, value in state_dict.items()}, strict=True)
    return model


def _describe_keys(state_dict: Mapping) -> str:
    return '\n'.join(f'  {key}: {tuple(np.shape(_to_numpy(value)))}'
                     for key, value in state_dict.items())


def load_ge2e_checkpoint(path_or_state_dict, config
                         ) -> Dict[str, torch.Tensor]:
    """The GE2E speaker encoder's weights from a torch checkpoint (a state
    dict, or a payload with one under ``Model``) under the port's names
    (``layer_Dict.GE2E.layer_Dict.LSTM.*``, ``…Projection.*``).

    The module paths inside such a checkpoint are not fixed, so the
    tensors are found by what torch names them whatever the path: each
    LSTM layer's ``…weight_ih_l{i}``, ``…weight_hh_l{i}``, ``…bias_ih_l{i}``
    and ``…bias_hh_l{i}``, and the projection as the one ``…weight``/
    ``…bias`` pair of shape ``[embedding_size, lstm_size]`` (the key
    discovery of ``glow_tts_tpu/utils/torch_import.py::
    convert_ge2e_state_dict``).  Raises ``KeyError`` listing the
    checkpoint's keys and shapes when one is missing or ambiguous."""
    sd = path_or_state_dict
    if not isinstance(sd, Mapping):
        sd = torch.load(sd, map_location='cpu', weights_only=True)
    if 'Model' in sd and isinstance(sd['Model'], Mapping):
        sd = sd['Model']
    ge2e = config.speaker_embedding.ge2e
    h, emb = ge2e.lstm.sizes, config.speaker_embedding.embedding_size
    mel = config.sound.mel_dim

    def fail(what):
        raise KeyError(f'GE2E checkpoint: {what}.\nCheckpoint contains:\n'
                       + _describe_keys(sd))

    out: Dict[str, torch.Tensor] = {}
    for i in range(ge2e.lstm.stacks):
        for part in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh'):
            matches = [key for key in sd if key.endswith(f'{part}_l{i}')]
            if len(matches) != 1:
                fail(f'expected exactly one key ending "{part}_l{i}", found '
                     f'{matches}')
            out[f'{GE2E_PREFIX}LSTM.{part}_l{i}'] = torch.as_tensor(
                _to_numpy(sd[matches[0]]))
        shape = tuple(out[f'{GE2E_PREFIX}LSTM.weight_ih_l{i}'].shape)
        expected = (4 * h, mel if i == 0 else h)
        if shape != expected:
            fail(f'LSTM layer {i} weight_ih has shape {shape}, expected '
                 f'{expected} for LSTM.Sizes={h}, Mel_Dim={mel}')
    candidates = [
        key for key, value in sd.items()
        if key.endswith('weight') and 'weight_ih' not in key
        and 'weight_hh' not in key and key[:-len('weight')] + 'bias' in sd
        and tuple(np.shape(_to_numpy(value))) == (emb, h)]
    if len(candidates) != 1:
        fail(f'expected exactly one [{emb}, {h}] projection weight/bias '
             f'pair, found {candidates}')
    out[f'{GE2E_PREFIX}Projection.weight'] = torch.as_tensor(
        _to_numpy(sd[candidates[0]]))
    out[f'{GE2E_PREFIX}Projection.bias'] = torch.as_tensor(
        _to_numpy(sd[candidates[0][:-len('weight')] + 'bias']))
    return out


def _conv_weight(kernel) -> np.ndarray:
    """flax [k, in, out] → torch [out, in, k]."""
    return np.asarray(kernel).transpose(2, 1, 0)


def _dense_weight(kernel) -> np.ndarray:
    """flax Dense [in, out] → torch 1×1 conv [out, in, 1]."""
    return np.asarray(kernel).T[:, :, None]


def _dense(out: Dict, prefix: str, p: Mapping) -> None:
    out[f'{prefix}.weight'] = _dense_weight(p['kernel'])
    out[f'{prefix}.bias'] = np.asarray(p['bias'])


def _conv(out: Dict, prefix: str, p: Mapping) -> None:
    out[f'{prefix}.weight'] = _conv_weight(p['conv']['kernel'])
    out[f'{prefix}.bias'] = np.asarray(p['conv']['bias'])


def _wnconv(out: Dict, prefix: str, p: Mapping) -> None:
    out[f'{prefix}.weight_g'] = np.asarray(p['g'])[:, None, None]
    out[f'{prefix}.weight_v'] = _conv_weight(p['v'])
    out[f'{prefix}.bias'] = np.asarray(p['b'])


def _layernorm(out: Dict, prefix: str, p: Mapping) -> None:
    out[f'{prefix}.weight'] = np.asarray(p['LayerNorm_0']['scale'])
    out[f'{prefix}.bias'] = np.asarray(p['LayerNorm_0']['bias'])


def _modes(config):
    """(speaker embedding, GE2E, prosody encoder, gradient reversal) of
    ``config``'s mode, from its ``mode`` and ``speaker_embedding`` fields
    alone, so that the JAX package's config serves as well."""
    mode = config.mode.upper()
    if mode not in ('VANILLA', 'SE', 'PE', 'GR'):
        raise ValueError(f'unknown mode {config.mode!r}')
    speaker = mode in ('SE', 'GR')
    return (speaker,
            speaker and config.speaker_embedding.type.upper() == 'GE2E',
            mode in ('PE', 'GR'), mode == 'GR')


def _ge2e(out: Dict, p: Mapping) -> None:
    """flax ``OptimizedLSTMCell`` layers (input kernels ``ii/if/ig/io``,
    hidden kernels and biases ``hi/hf/hg/ho``, gates i, f, g, o) and the
    projection Dense → ``nn.LSTM`` and ``nn.Linear``."""
    i = 0
    while f'lstm_cell_{i}' in p:
        cell = p[f'lstm_cell_{i}']
        w_hh = np.concatenate([np.asarray(cell[f'h{g}']['kernel']).T
                               for g in 'ifgo'])
        lstm = f'{GE2E_PREFIX}LSTM'
        out[f'{lstm}.weight_ih_l{i}'] = np.concatenate(
            [np.asarray(cell[f'i{g}']['kernel']).T for g in 'ifgo'])
        out[f'{lstm}.weight_hh_l{i}'] = w_hh
        out[f'{lstm}.bias_ih_l{i}'] = np.zeros(w_hh.shape[0], w_hh.dtype)
        out[f'{lstm}.bias_hh_l{i}'] = np.concatenate(
            [np.asarray(cell[f'h{g}']['bias']) for g in 'ifgo'])
        i += 1
    out[f'{GE2E_PREFIX}Projection.weight'] = np.asarray(
        p['projection']['kernel']).T
    out[f'{GE2E_PREFIX}Projection.bias'] = np.asarray(p['projection']['bias'])


def _prosody(out: Dict, p: Mapping, config) -> None:
    """The GST encoder as ``glow_tts_tpu/utils/torch_export.py::
    _export_prosody`` writes it: Conv2d ``[k_time, k_mel, in, out]`` →
    ``[out, in, k_mel, k_time]``; the GRU with flax's h-side r/z biases
    folded into the i-side and ``bias_hh``'s r/z rows zero; the style
    tokens transposed."""
    pe = 'layer_Dict.Prosody_Encoder.layer_Dict'
    ref = config.prosody_encoder.reference_encoder
    for i in range(len(ref.conv.kernel_size)):
        out[f'{pe}.Conv_{i}.Conv.weight'] = np.asarray(
            p[f'conv_{i}']['kernel']).transpose(3, 2, 1, 0)
    for i in range(ref.gru.stacks):
        cell = p[f'gru_cell_{i}']
        w_hh = np.concatenate([np.asarray(cell[g]['kernel']).T
                               for g in ('hr', 'hz', 'hn')])
        h = w_hh.shape[1]
        out[f'{pe}.GRU.weight_ih_l{i}'] = np.concatenate(
            [np.asarray(cell[g]['kernel']).T for g in ('ir', 'iz', 'in')])
        out[f'{pe}.GRU.weight_hh_l{i}'] = w_hh
        out[f'{pe}.GRU.bias_ih_l{i}'] = np.concatenate(
            [np.asarray(cell[g]['bias']) for g in ('ir', 'iz', 'in')])
        out[f'{pe}.GRU.bias_hh_l{i}'] = np.concatenate(
            [np.zeros(h, np.float32), np.zeros(h, np.float32),
             np.asarray(cell['hn']['bias'])])
    for name, key in _ATTENTION:
        _dense(out, f'{pe}.Attention.layer_Dict.{name}',
               p['attention'][key])
    out['layer_Dict.Prosody_Encoder.gst_Tokens'] = np.asarray(
        p['style_tokens']).T


_ATTENTION = [('Query', 'query'), ('Key', 'key'), ('Value', 'value'),
              ('Projection', 'proj')]
_CLASSIFIER = 'layer_Dict.Speaker_Classifier_GR.layer'
# the conditioning convs of a WaveNet layer: reference name, JAX name
_WAVENET_CONDITIONING = (('Speaker', 'speaker'), ('Prosody', 'prosody'),
                         ('Pitch', 'pitch'))


def _wavenet_conditioning(config):
    """The (reference, JAX) names of the WaveNet's conditioning convs in
    ``config``'s mode."""
    speaker, _, prosody, gr = _modes(config)
    return [names for names, used in zip(_WAVENET_CONDITIONING,
                                         (speaker, prosody, gr)) if used]


def convert_params_to_reference(params: Mapping, config
                                ) -> Dict[str, np.ndarray]:
    """flax params of the JAX package → the reference's
    ``GlowTTS.state_dict()`` names and layouts (numpy values), in any of
    the four modes; GE2E mode's encoder follows under the port's names.
    ``config`` is the port's ``Config`` or the JAX package's."""
    speaker, ge2e, prosody, gr = _modes(config)
    enc_p = params['encoder']
    enc = 'layer_Dict.Encoder.layer_Dict'
    sd: Dict[str, np.ndarray] = {}

    sd[f'{enc}.Embedding.weight'] = np.asarray(
        enc_p['embedding']['embedding'])
    _dense(sd, f'{enc}.Prenet.layer_Dict.Conv1x1',
           enc_p['prenet']['proj']['dense'])
    for i in range(config.encoder.prenet.stacks):
        base = f'{enc}.Prenet.layer_Dict.CLRD_{i}.layer_Dict'
        _conv(sd, f'{base}.Conv', enc_p['prenet'][f'conv_{i}'])
        _layernorm(sd, f'{base}.LayerNorm', enc_p['prenet'][f'norm_{i}'])
    for i in range(config.encoder.transformer.stacks):
        base = f'{enc}.Transformer.layer_Dict.ANCRDCN_{i}.layer_Dict'
        block = enc_p[f'block_{i}']
        for name, key in _ATTENTION:
            _dense(sd, f'{base}.Attention.layer_Dict.{name}',
                   block['attention'][key])
        sd[f'{base}.Attention.weight_K'] = np.asarray(
            block['attention']['rel_emb_k'])
        sd[f'{base}.Attention.weight_V'] = np.asarray(
            block['attention']['rel_emb_v'])
        _layernorm(sd, f'{base}.LayerNorm_0', block['norm_0'])
        _layernorm(sd, f'{base}.LayerNorm_1', block['norm_1'])
        _conv(sd, f'{base}.Conv_0', block['conv_0'])
        _conv(sd, f'{base}.Conv_1', block['conv_1'])
    _dense(sd, f'{enc}.Project', enc_p['project']['dense'])
    dur = enc_p['duration_predictor']
    for i in range(config.encoder.duration_predictor.stacks):
        _conv(sd, f'{enc}.Duration_Predictor.layer_Dict.CRND_{i}'
                  f'.layer_Dict.Conv', dur[f'conv_{i}'])
    _dense(sd, f'{enc}.Duration_Predictor.layer_Dict.Projection',
           dur['proj']['dense'])

    for k in range(config.decoder.stack):
        flow = f'layer_Dict.Decoder.layer_Dict.Flows.{k}'
        fp = params['decoder'][f'flow_{k}']
        sd[f'{flow}.layers.0.logs'] = np.asarray(
            fp['actnorm']['logs'])[None, :, None]
        sd[f'{flow}.layers.0.bias'] = np.asarray(
            fp['actnorm']['bias'])[None, :, None]
        sd[f'{flow}.layers.1.weight'] = np.asarray(fp['invconv']['weight'])
        _wnconv(sd, f'{flow}.layers.2.layer_Dict.Start',
                fp['coupling']['start'])
        _dense(sd, f'{flow}.layers.2.layer_Dict.End',
               fp['coupling']['end']['dense'])
        wn = fp['coupling']['wavenet']
        for i in range(config.decoder.affine_coupling.wavenet.num_layers):
            base = f'{flow}.layers.2.layer_Dict.WaveNet.layer_Dict'
            _wnconv(sd, f'{base}.In_{i}', wn[f'in_{i}'])
            _wnconv(sd, f'{base}.Res_Skip_{i}', wn[f'res_skip_{i}'])
            for name, key in _wavenet_conditioning(config):
                _wnconv(sd, f'{base}.{name}_{i}', wn[f'{key}_{i}'])

    if speaker and not ge2e:
        sd['layer_Dict.LUT.weight'] = np.asarray(
            params['speaker_lut']['lut']['embedding'])
    if prosody:
        _prosody(sd, params['prosody_encoder'], config)
    if gr:
        cls = params['speaker_classifier']
        channels = config.speaker_classifier_gr.channels
        for i in range(len(channels)):
            _dense(sd, f'{_CLASSIFIER}.Hidden_{i}', cls[f'hidden_{i}'])
        _dense(sd, f'{_CLASSIFIER}.Output_{len(channels) - 1}', cls['output'])
    if ge2e:
        _ge2e(sd, params['ge2e'])
    return sd


def load_jax_params(model: nn.Module, params_np: Mapping,
                    config) -> nn.Module:
    """Load a JAX parameter tree (numpy leaves, unfolded weight norm) into
    the port.  ``config`` is the port's ``Config`` for those params (the
    JAX package's has the same fields and serves as well)."""
    return load_state_dict(model,
                           convert_params_to_reference(params_np, config))


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _inv_dense(sd: Mapping, prefix: str) -> Dict:
    return {'kernel': _to_numpy(sd[f'{prefix}.weight'])[:, :, 0].T,
            'bias': _to_numpy(sd[f'{prefix}.bias'])}


def _inv_conv(sd: Mapping, prefix: str) -> Dict:
    return {'conv': {
        'kernel': _to_numpy(sd[f'{prefix}.weight']).transpose(2, 1, 0),
        'bias': _to_numpy(sd[f'{prefix}.bias'])}}


def _inv_wnconv(sd: Mapping, prefix: str) -> Dict:
    return {'g': _to_numpy(sd[f'{prefix}.weight_g'])[:, 0, 0],
            'v': _to_numpy(sd[f'{prefix}.weight_v']).transpose(2, 1, 0),
            'b': _to_numpy(sd[f'{prefix}.bias'])}


def _inv_layernorm(sd: Mapping, prefix: str) -> Dict:
    return {'LayerNorm_0': {'scale': _to_numpy(sd[f'{prefix}.weight']),
                            'bias': _to_numpy(sd[f'{prefix}.bias'])}}


def reference_to_params(sd: Mapping, config) -> Dict:
    """The inverse of :func:`convert_params_to_reference`: a mapping from
    the reference's state-dict names (tensors or numpy arrays) to the JAX
    package's parameter tree, numpy leaves in flax layouts."""
    speaker, ge2e, prosody, gr = _modes(config)
    enc = 'layer_Dict.Encoder.layer_Dict'
    enc_p: Dict = {
        'embedding': {'embedding': _to_numpy(sd[f'{enc}.Embedding.weight'])},
        'prenet': {'proj': {'dense': _inv_dense(
            sd, f'{enc}.Prenet.layer_Dict.Conv1x1')}},
        'project': {'dense': _inv_dense(sd, f'{enc}.Project')},
    }
    for i in range(config.encoder.prenet.stacks):
        base = f'{enc}.Prenet.layer_Dict.CLRD_{i}.layer_Dict'
        enc_p['prenet'][f'conv_{i}'] = _inv_conv(sd, f'{base}.Conv')
        enc_p['prenet'][f'norm_{i}'] = _inv_layernorm(sd, f'{base}.LayerNorm')
    for i in range(config.encoder.transformer.stacks):
        base = f'{enc}.Transformer.layer_Dict.ANCRDCN_{i}.layer_Dict'
        attention = {key: _inv_dense(
            sd, f'{base}.Attention.layer_Dict.{name}')
            for name, key in _ATTENTION}
        attention['rel_emb_k'] = _to_numpy(sd[f'{base}.Attention.weight_K'])
        attention['rel_emb_v'] = _to_numpy(sd[f'{base}.Attention.weight_V'])
        enc_p[f'block_{i}'] = {
            'attention': attention,
            'norm_0': _inv_layernorm(sd, f'{base}.LayerNorm_0'),
            'norm_1': _inv_layernorm(sd, f'{base}.LayerNorm_1'),
            'conv_0': _inv_conv(sd, f'{base}.Conv_0'),
            'conv_1': _inv_conv(sd, f'{base}.Conv_1')}
    dur = f'{enc}.Duration_Predictor.layer_Dict'
    enc_p['duration_predictor'] = {
        'proj': {'dense': _inv_dense(sd, f'{dur}.Projection')},
        **{f'conv_{i}': _inv_conv(sd, f'{dur}.CRND_{i}.layer_Dict.Conv')
           for i in range(config.encoder.duration_predictor.stacks)}}

    dec_p: Dict = {}
    for k in range(config.decoder.stack):
        flow = f'layer_Dict.Decoder.layer_Dict.Flows.{k}'
        base = f'{flow}.layers.2.layer_Dict'
        wavenet: Dict = {}
        for i in range(config.decoder.affine_coupling.wavenet.num_layers):
            wn = f'{base}.WaveNet.layer_Dict'
            wavenet[f'in_{i}'] = _inv_wnconv(sd, f'{wn}.In_{i}')
            wavenet[f'res_skip_{i}'] = _inv_wnconv(sd, f'{wn}.Res_Skip_{i}')
            for name, key in _wavenet_conditioning(config):
                wavenet[f'{key}_{i}'] = _inv_wnconv(sd, f'{wn}.{name}_{i}')
        dec_p[f'flow_{k}'] = {
            'actnorm': {
                'logs': _to_numpy(sd[f'{flow}.layers.0.logs'])[0, :, 0],
                'bias': _to_numpy(sd[f'{flow}.layers.0.bias'])[0, :, 0]},
            'invconv': {'weight': _to_numpy(sd[f'{flow}.layers.1.weight'])},
            'coupling': {'start': _inv_wnconv(sd, f'{base}.Start'),
                         'end': {'dense': _inv_dense(sd, f'{base}.End')},
                         'wavenet': wavenet}}
    params = {'encoder': enc_p, 'decoder': dec_p}
    if speaker and not ge2e:
        params['speaker_lut'] = {'lut': {'embedding': _to_numpy(
            sd['layer_Dict.LUT.weight'])}}
    if ge2e:
        params['ge2e'] = _inv_ge2e(sd, config)
    if prosody:
        params['prosody_encoder'] = _inv_prosody(sd, config)
    if gr:
        channels = config.speaker_classifier_gr.channels
        params['speaker_classifier'] = {
            **{f'hidden_{i}': _inv_dense(sd, f'{_CLASSIFIER}.Hidden_{i}')
               for i in range(len(channels))},
            'output': _inv_dense(sd, f'{_CLASSIFIER}.Output_'
                                     f'{len(channels) - 1}')}
    return params


def _inv_ge2e(sd: Mapping, config) -> Dict:
    """``nn.LSTM``/``nn.Linear`` → flax ``OptimizedLSTMCell`` layers (the
    two torch biases summed on the hidden side) and the projection."""
    lstm = f'{GE2E_PREFIX}LSTM'
    out: Dict = {}
    for i in range(config.speaker_embedding.ge2e.lstm.stacks):
        w_ih = _to_numpy(sd[f'{lstm}.weight_ih_l{i}'])
        w_hh = _to_numpy(sd[f'{lstm}.weight_hh_l{i}'])
        bias = (_to_numpy(sd[f'{lstm}.bias_ih_l{i}'])
                + _to_numpy(sd[f'{lstm}.bias_hh_l{i}']))
        h = w_hh.shape[1]
        cell: Dict = {}
        for n, g in enumerate('ifgo'):
            rows = slice(n * h, (n + 1) * h)
            cell[f'i{g}'] = {'kernel': w_ih[rows].T}
            cell[f'h{g}'] = {'kernel': w_hh[rows].T, 'bias': bias[rows]}
        out[f'lstm_cell_{i}'] = cell
    out['projection'] = {
        'kernel': _to_numpy(sd[f'{GE2E_PREFIX}Projection.weight']).T,
        'bias': _to_numpy(sd[f'{GE2E_PREFIX}Projection.bias'])}
    return out


def _inv_prosody(sd: Mapping, config) -> Dict:
    """The inverse of :func:`_prosody` (the GRU's torch biases of r and z
    summed on the input side, as flax has them)."""
    pe = 'layer_Dict.Prosody_Encoder.layer_Dict'
    ref = config.prosody_encoder.reference_encoder
    out: Dict = {
        f'conv_{i}': {'kernel': _to_numpy(
            sd[f'{pe}.Conv_{i}.Conv.weight']).transpose(3, 2, 1, 0)}
        for i in range(len(ref.conv.kernel_size))}
    for i in range(ref.gru.stacks):
        w_ih = _to_numpy(sd[f'{pe}.GRU.weight_ih_l{i}'])
        w_hh = _to_numpy(sd[f'{pe}.GRU.weight_hh_l{i}'])
        b_ih = _to_numpy(sd[f'{pe}.GRU.bias_ih_l{i}'])
        b_hh = _to_numpy(sd[f'{pe}.GRU.bias_hh_l{i}'])
        h = w_hh.shape[1]
        r, z, n = slice(0, h), slice(h, 2 * h), slice(2 * h, 3 * h)
        out[f'gru_cell_{i}'] = {
            'ir': {'kernel': w_ih[r].T, 'bias': b_ih[r] + b_hh[r]},
            'iz': {'kernel': w_ih[z].T, 'bias': b_ih[z] + b_hh[z]},
            'in': {'kernel': w_ih[n].T, 'bias': b_ih[n]},
            'hr': {'kernel': w_hh[r].T},
            'hz': {'kernel': w_hh[z].T},
            'hn': {'kernel': w_hh[n].T, 'bias': b_hh[n]}}
    out['attention'] = {key: _inv_dense(
        sd, f'{pe}.Attention.layer_Dict.{name}') for name, key in _ATTENTION}
    out['style_tokens'] = _to_numpy(
        sd['layer_Dict.Prosody_Encoder.gst_Tokens']).T
    return out


def gradients_as_jax_params(model: nn.Module, config) -> Dict:
    """The gradients of ``model``'s parameters (``.grad``; zero where
    there is none) named and laid out as the JAX parameter tree."""
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
             for name, p in model.named_parameters()}
    return reference_to_params(grads, config)
