"""Weights into the port.

The port's modules carry the reference's state-dict names, so three
sources load the same way, with ``load_state_dict(strict=True)``:

* the reference's ``S_<step>.pt`` checkpoints, and the JAX package's
  ``save_reference_checkpoint`` output, which has the same payload;
* JAX parameters held as numpy arrays, renamed and re-laid-out by
  :func:`convert_params_to_reference`, this package's own copy of the
  name map of ``glow_tts_tpu/utils/torch_export.py`` (a CPU test holds the
  two equal bit for bit).
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
