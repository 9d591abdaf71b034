"""The slice at bfloat16, continued (``tests/test_torch_bf16_train_step.py``
states the tolerance and the setting): three train steps against JAX
``make_train_step`` in GR mode under ``'flax'`` and ``'mega_interpret'``,
and the 'em' warmup's step with the decoder frozen at ``Num_Squeeze: 1``
(MiniSpeech's layout) under ``'mega_interpret'``; one eval step against
JAX ``make_eval_step`` under ``'fused_interpret'`` (the flow-step kernel at
bf16, the port's ``'fused'`` route); ``data_dependent_init`` against
``create_train_state``'s ActNorm at bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.training.step import build_model, make_eval_step
from glow_tts_tpu_torch.weights import load_jax_params
from tests.test_torch_bf16_train_step import (_batch, _check_gradients,
                                              _check_losses, _config,
                                              _perturbed, _run)
from tests.torch_port_helpers import (assert_bf16_close, at_dtype,
                                      port_config, t)

CASES = [('GR', 'flax', False), ('GR', 'mega_interpret', False),
         ('Vanilla', 'mega_interpret', True)]


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{m}-{b}{"-em-squeeze1" if e else ""}'
                     for m, b, e in CASES])
def run(request):
    return _run(*request.param)


def test_three_bf16_steps_match_jax(run):
    _check_losses(run)


def test_first_bf16_step_gradients_leaf_by_leaf(run):
    _check_gradients(run)


def test_bf16_eval_step_matches_jax_fused():
    cfg = _config('GR', 'fused_interpret')
    batch = _batch(cfg, False)
    params = _perturbed(cfg, batch)
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}
    refs = {}
    for dtype in ('float32', 'bfloat16'):
        c = at_dtype(cfg, dtype)
        state = jstep.create_train_state(c, jax.random.PRNGKey(0), batch)[1]
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
        losses, outputs = jax.jit(jstep.make_eval_step(
            c, jstep.build_model(c)))(state, jbatch)
        refs[dtype] = ({key: float(v) for key, v in losses.items()},
                       np.asarray(outputs['attentions']),
                       np.asarray(outputs['z']))
    pcfg = port_config(at_dtype(cfg, 'bfloat16'))
    assert pcfg.flow_route == 'fused'
    port = load_jax_params(build_model(pcfg), params, pcfg).prepare()
    path = torch.from_numpy(refs['bfloat16'][1].copy())
    losses, outputs = make_eval_step(pcfg, port,
                                     mas_fn=lambda *a: path)(
        {key: t(value) for key, value in batch.items()})
    keys = sorted(refs['float32'][0])
    assert sorted(losses) == keys
    assert_bf16_close([float(losses[key]) for key in keys],
                      [refs['bfloat16'][0][key] for key in keys],
                      [refs['float32'][0][key] for key in keys], 'losses')
    assert outputs['z'].dtype == torch.float32
    assert_bf16_close(outputs['z'], refs['bfloat16'][2], refs['float32'][2],
                      'z')


@pytest.mark.parametrize('mode', ['Vanilla', 'GR'])
def test_bf16_data_dependent_init_matches_create_train_state(mode):
    """ActNorm's statistics from the first batch, the flow run at bf16
    between the steps: every step's logs and bias against the JAX
    package's ``create_train_state`` at bf16 (its other parameters are
    those of the f32 state: the same initialisers, the same key)."""
    cfg = _config(mode, 'mega_interpret')
    batch = _batch(cfg, False)
    states = {dtype: jstep.create_train_state(
        at_dtype(cfg, dtype), jax.random.PRNGKey(0), batch)[1].params
        for dtype in ('float32', 'bfloat16')}

    def actnorm(params):
        return np.concatenate([
            np.asarray(params['decoder'][f'flow_{i}']['actnorm'][key])
            for i in range(cfg.decoder.stack) for key in ('logs', 'bias')])

    pcfg = port_config(at_dtype(cfg, 'bfloat16'))
    port = load_jax_params(build_model(pcfg), jax.tree_util.tree_map(
        np.asarray, states['float32']), pcfg).prepare(fold=False)
    tensors = {key: t(value) for key, value in batch.items()}
    for step in port.layer_Dict['Decoder'].layer_Dict['Flows']:
        with torch.no_grad():
            step.layers[0].logs.zero_()
            step.layers[0].bias.zero_()
    port.data_dependent_init(tensors['mels'], tensors['mel_lengths'],
                             **{key: tensors[key] for key in
                                ('speakers', 'mels_for_ge2e', 'pitches')
                                if key in tensors})
    got = np.concatenate([
        step.layers[0].__getattr__(key).detach().reshape(-1).numpy()
        for step in port.layer_Dict['Decoder'].layer_Dict['Flows']
        for key in ('logs', 'bias')])
    assert_bf16_close(got, actnorm(states['bfloat16']),
                      actnorm(states['float32']), 'ActNorm logs, bias')
