"""Weights into the port, and gradients back out.

The port's modules carry the reference's state-dict names, so three
sources load the same way, with ``load_state_dict(strict=True)``:

* the reference's ``S_<step>.pt`` checkpoints, and the JAX package's
  ``save_reference_checkpoint`` output, which has the same payload;
* JAX parameters held as numpy arrays, renamed and re-laid-out by
  :func:`convert_params_to_reference`, this package's own copy of the
  name map of ``glow_tts_tpu/utils/torch_export.py`` (a CPU test holds the
  two equal bit for bit).

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


def load_state_dict(model: nn.Module,
                    state_dict: Mapping[str, object]) -> nn.Module:
    """Load a reference-format state dict (tensors or numpy arrays)."""
    model.load_state_dict(
        {key: torch.as_tensor(np.ascontiguousarray(value))
         if isinstance(value, np.ndarray) else value
         for key, value in state_dict.items()}, strict=True)
    return model


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


def convert_params_to_reference(params: Mapping, config
                                ) -> Dict[str, np.ndarray]:
    """flax params of the JAX package → the reference's
    ``GlowTTS.state_dict()`` names and layouts (numpy values), for the
    modes the port has.  ``config`` is the port's ``Config`` or any object
    with the same ``mode``, ``encoder`` and ``decoder`` fields."""
    if config.mode.upper() != 'VANILLA':
        raise NotImplementedError(
            f'the PyTorch port converts Vanilla parameters only '
            f'(got mode {config.mode!r})')
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
        for name, key in [('Query', 'query'), ('Key', 'key'),
                          ('Value', 'value'), ('Projection', 'proj')]:
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
    if config.mode.upper() != 'VANILLA':
        raise NotImplementedError(
            f'the PyTorch port converts Vanilla parameters only '
            f'(got mode {config.mode!r})')
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
            for name, key in [('Query', 'query'), ('Key', 'key'),
                              ('Value', 'value'), ('Projection', 'proj')]}
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
        dec_p[f'flow_{k}'] = {
            'actnorm': {
                'logs': _to_numpy(sd[f'{flow}.layers.0.logs'])[0, :, 0],
                'bias': _to_numpy(sd[f'{flow}.layers.0.bias'])[0, :, 0]},
            'invconv': {'weight': _to_numpy(sd[f'{flow}.layers.1.weight'])},
            'coupling': {'start': _inv_wnconv(sd, f'{base}.Start'),
                         'end': {'dense': _inv_dense(sd, f'{base}.End')},
                         'wavenet': wavenet}}
    return {'encoder': enc_p, 'decoder': dec_p}


def gradients_as_jax_params(model: nn.Module, config) -> Dict:
    """The gradients of ``model``'s parameters (``.grad``; zero where
    there is none) named and laid out as the JAX parameter tree."""
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
             for name, p in model.named_parameters()}
    return reference_to_params(grads, config)
