"""Weights, configuration and imports of the PyTorch port:

* the JAX → port bridge (the port's own copy of the JAX exporter's name
  map, then ``load_state_dict(strict=True)``): the copy's output equals
  the JAX exporter's bit for bit, and the port's state-dict names and
  shapes are exactly the exporter's for Vanilla;
* the inverse map (``reference_to_params``, which carries the port's
  gradients onto the JAX tree's names) undoes the exporter exactly;
* weight norm folded at load equals ``fold_weight_norm_params``;
* an ``S_<step>.pt`` written by ``save_reference_checkpoint`` serves;
* the port's config and text rules agree field by field with the JAX
  package's, ``coupling_backend`` under the port's names for its values;
* the decoder's stacked pack (the ``'mega'`` route's weights) equals, key
  by key and in both directions, what the JAX ``FlowDecoder._mega`` stacks;
* ``glow_tts_tpu_torch`` runs a decode without importing jax or the JAX
  package, and no source file of the port or of ``chip_smoke.py`` holds
  such an import.
"""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu import text as jtext
from glow_tts_tpu.config import load_config as jax_load_config
from glow_tts_tpu.models import decoder as jd
from glow_tts_tpu.models.layers import fold_weight_norm_params
from glow_tts_tpu.utils.torch_export import (convert_params_to_reference,
                                             save_reference_checkpoint)
from glow_tts_tpu_torch import text as ttext
from glow_tts_tpu_torch.config import coupling_backend_name, load_config
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.weights import convert_params_to_reference as port_convert
from glow_tts_tpu_torch.weights import (gradients_as_jax_params,
                                        load_jax_params, reference_to_params)
from tests.torch_port_helpers import (jax_model, port_config, port_model,
                                      ragged, with_backend)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def setup():
    cfg, _, params, _ = jax_model(seed=5)
    return cfg, params


def test_state_dict_names_and_shapes_are_the_exporters(setup):
    cfg, params = setup
    exported = convert_params_to_reference(params, cfg)
    port = GlowTTS(port_config(cfg)).state_dict()
    assert sorted(port) == sorted(exported)
    for key, value in exported.items():
        assert tuple(port[key].shape) == value.shape, key
    model = load_jax_params(GlowTTS(port_config(cfg)), params, cfg)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), exported[key],
                                      err_msg=key)


@pytest.mark.parametrize('config_of', ['port', 'jax'])
def test_own_exporter_equals_the_jax_exporter(setup, config_of):
    cfg, params = setup
    exported = convert_params_to_reference(params, cfg)
    own = port_convert(params, port_config(cfg) if config_of == 'port'
                       else cfg)
    assert list(own) == list(exported)
    for key, value in exported.items():
        assert own[key].dtype == value.dtype, key
        np.testing.assert_array_equal(own[key], value, err_msg=key)


def test_inverse_map_undoes_the_exporter(setup):
    import jax
    cfg, params = setup
    back = reference_to_params(port_convert(params, cfg), port_config(cfg))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], np.asarray(value),
                                      err_msg=jax.tree_util.keystr(path))
    # gradients ride the same map: a parameter's .grad lands on its leaf
    model = load_jax_params(GlowTTS(port_config(cfg)), params, cfg)
    for p in model.parameters():
        p.grad = 2.0 * p.detach()
    grads = dict(jax.tree_util.tree_leaves_with_path(
        gradients_as_jax_params(model, port_config(cfg))))
    for path, value in ref.items():
        np.testing.assert_array_equal(grads[path], 2.0 * np.asarray(value),
                                      err_msg=jax.tree_util.keystr(path))
    # the four modes convert (tests/test_torch_modes.py); no other does
    with pytest.raises(ValueError, match='XX'):
        reference_to_params({}, dataclasses.replace(cfg, mode='XX'))


def test_own_exporter_refuses_other_modes(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match='XX'):
        port_convert(params, dataclasses.replace(cfg, mode='XX'))


def test_fold_matches_jax_fold(setup):
    cfg, params = setup
    folded = fold_weight_norm_params(params)
    model = port_model(cfg, params)
    for k in range(cfg.decoder.stack):
        jflow = folded['decoder'][f'flow_{k}']['coupling']
        tflow = (model.layer_Dict['Decoder'].layer_Dict['Flows'][k]
                 .layers[2].layer_Dict)
        pairs = [(tflow['Start'], jflow['start'])]
        for i in range(cfg.decoder.affine_coupling.wavenet.num_layers):
            wn = tflow['WaveNet'].layer_Dict
            pairs += [(wn[f'In_{i}'], jflow['wavenet'][f'in_{i}']),
                      (wn[f'Res_Skip_{i}'], jflow['wavenet'][f'res_skip_{i}'])]
        for module, ref in pairs:
            assert module.folded is not None
            assert 'g' not in ref
            np.testing.assert_allclose(
                module.effective_weight().numpy(),
                np.asarray(ref['v']).transpose(2, 1, 0), rtol=1e-6,
                atol=1e-7)


@pytest.mark.parametrize('reverse', [False, True])
def test_stacked_pack_matches_what_jax_stacks(setup, reverse):
    """``FlowDecoder.stacked_weights``/``stacked_cond`` against the JAX
    ``FlowDecoder._mega``'s stack of ``FlowStep(..., return_params=True)``
    per step, in forward order in both directions."""
    cfg, params = setup
    decoder = port_model(cfg, params).layer_Dict['Decoder']
    c = cfg.sound.mel_dim * cfg.decoder.num_squeeze
    x, mask = ragged(np.random.default_rng(4), 2, 6, c, [6, 3])
    gathered = [jd.FlowStep(cfg).apply(
        {'params': params['decoder'][f'flow_{k}']}, jnp.asarray(x),
        jnp.asarray(mask), reverse=reverse, return_params=True)
        for k in range(cfg.decoder.stack)]
    ref = {key: np.stack([np.asarray(w[key]) for w, _ in gathered])
           for key in gathered[0][0]}
    ref_cond = np.stack([np.asarray(cond) for _, cond in gathered])

    got = decoder.stacked_weights(reverse)
    assert set(got) == set(ref)
    assert ('ld_const' in got) == (not reverse)
    for key, value in ref.items():
        assert got[key].is_contiguous() and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), value, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    cond = decoder.stacked_cond(2)
    assert cond.is_contiguous()
    np.testing.assert_allclose(cond.numpy(), ref_cond, rtol=0, atol=0)
    # kept until the parameters change
    assert decoder.stacked_weights(reverse) is got
    decoder.invalidate()
    assert decoder.stacked_weights(reverse) is not got


def test_serves_from_a_reference_checkpoint_file(setup, tmp_path):
    cfg, params = setup
    path = str(tmp_path / 'S_5.pt')
    save_reference_checkpoint(params, cfg, 5, path)
    inferencer = Inferencer(path, port_config(cfg), 'cpu', batch_size=2)
    expected = load_jax_params(GlowTTS(port_config(cfg)), params, cfg)
    for key, value in expected.state_dict().items():
        torch.testing.assert_close(inferencer.model.state_dict()[key], value,
                                   rtol=0, atol=0)
    out = inferencer.inference(['x'], ['A test, from a file.'])
    assert np.isfinite(out[0]['mel']).all()


def _port_fields(port_obj, jax_obj, path=''):
    """(path, port value, JAX value) for every leaf field of the port's
    config; the two buckets, the decoder's backend, the dtypes and the
    parallel fields live under ``TPU`` in the JAX config, the backend's
    values under the JAX names."""
    for f in dataclasses.fields(port_obj):
        value = getattr(port_obj, f.name)
        ref = (getattr(jax_obj.tpu, f.name)
               if f.name in ('token_bucket', 'mel_bucket', 'coupling_backend',
                             'compute_dtype', 'param_dtype',
                             'inference_dtype', 'data_parallel',
                             'model_parallel')
               else getattr(jax_obj, f.name))
        if f.name == 'coupling_backend':
            ref = coupling_backend_name(ref)
        if dataclasses.is_dataclass(value):
            yield from _port_fields(value, ref, f'{path}{f.name}.')
        else:
            yield f'{path}{f.name}', value, ref


@pytest.mark.parametrize('source', ['yaml', 'tiny'])
def test_config_fields_match_jax(source, setup):
    if source == 'yaml':
        path = os.path.join(REPO, 'configs', 'Hyper_Parameters.yaml')
        port, ref = load_config(path), jax_load_config(path)
    else:
        ref = setup[0]
        port = port_config(ref)
    fields = list(_port_fields(port, ref))
    assert len(fields) >= 32
    assert 'train.adam.epsilon' in [name for name, _, _ in fields]
    assert 'mel_bucket' in [name for name, _, _ in fields]
    assert 'coupling_backend' in [name for name, _, _ in fields]
    for name, value, expected in fields:
        assert value == expected, name


def test_config_reads_both_buckets_from_the_tpu_section():
    data = {'TPU': {'token_bucket': 16, 'mel_bucket': 64}}
    port, ref = load_config(data), jax_load_config(data)
    assert (port.token_bucket, port.mel_bucket) == (16, 64)
    assert (ref.tpu.token_bucket, ref.tpu.mel_bucket) == (16, 64)


@pytest.mark.parametrize('jax_value,name,route', [
    ('auto', 'auto', 'fused'), ('flax', 'modules', 'modules'),
    ('fused', 'fused', 'fused'), ('fused_interpret', 'fused', 'fused'),
    ('mega', 'mega', 'mega'), ('mega_interpret', 'mega', 'mega')])
def test_config_reads_the_coupling_backend(setup, jax_value, name, route):
    """From the YAML's ``TPU`` section and from the JAX config's field
    tree: the JAX package's values under the port's names, ``'auto'``
    resolved to the per-step kernel."""
    data = {'TPU': {'coupling_backend': jax_value}}
    assert jax_load_config(data).tpu.coupling_backend == jax_value
    for port in (load_config(data),
                 port_config(with_backend(setup[0], jax_value))):
        assert (port.coupling_backend, port.flow_route) == (name, route)


def test_config_refuses_an_unknown_coupling_backend():
    with pytest.raises(ValueError, match='coupling_backend'):
        load_config({'TPU': {'coupling_backend': 'pallas'}})
    with pytest.raises(ValueError, match='coupling_backend'):
        dataclasses.replace(load_config({}), coupling_backend='Mega')


def test_config_refuses_other_modes():
    with pytest.raises(ValueError, match='Mode'):
        load_config({'Mode': 'XX'})
    with pytest.raises(ValueError, match='Type'):
        load_config({'Mode': 'SE', 'Speaker_Embedding': {'Type': 'XX'}})


def test_text_rules_match_jax():
    assert ttext.default_token_dict() == jtext.default_token_dict()
    assert len(ttext.default_token_dict()) == 35
    samples = ['Hello, world!', "  it's (a) [test]: fine;  ", "'quoted",
               'Two 2 runs', 'ok -- dash?', 'lower case.']
    for sample in samples:
        assert ttext.text_filtering(sample) == jtext.text_filtering(sample)
    texts = [jtext.text_filtering(s) for s in samples]
    texts = [s for s in texts if s]
    for pad_to in (None, 40):
        got = ttext.Tokenizer().encode_batch(texts, pad_to=pad_to)
        ref = jtext.Tokenizer().encode_batch(texts, pad_to=pad_to)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


_NO_JAX = r'''
import sys
from glow_tts_tpu_torch import Inferencer, load_config, random_state_dict
cfg = load_config({
    'Sound': {'Mel_Dim': 8}, 'Mode': 'Vanilla',
    'Encoder': {'Channels': 16, 'Prenet': {'Stacks': 1},
                'Transformer': {'Attention': {'Heads': 2, 'Window_Size': 2},
                                'Conv': {'Calc_Channels': 32}, 'Stacks': 1},
                'Duration_Predictor': {'Channels': 16}},
    'Decoder': {'Stack': 2, 'Affine_Coupling': {
        'Calc_Channels': 16, 'WaveNet': {'Num_Layers': 2}}}})
out = Inferencer(random_state_dict(cfg, 0), cfg, 'cpu').inference(
    ['a'], ['No jax here.'])
assert out[0]['mel'].shape[1] == 8
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                       'glow_tts_tpu'))
print('LOADED', loaded)
'''


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'LOADED []' in proc.stdout, proc.stdout


_FORBIDDEN_IMPORT = re.compile(
    r'^\s*(?:from|import)\s+(?:jax|jaxlib|flax|optax|glow_tts_tpu)(?![\w])',
    re.MULTILINE)


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """Read the sources: ``sys.modules`` in this process is tainted by the
    tests' own imports."""
    sources = sorted(glob.glob(os.path.join(REPO, 'glow_tts_tpu_torch', '**',
                                            '*.py'), recursive=True))
    sources.append(os.path.join(REPO, 'chip_smoke.py'))
    assert len(sources) >= 20
    for path in sources:
        with open(path, encoding='utf-8') as f:
            found = _FORBIDDEN_IMPORT.findall(f.read())
        assert not found, (path, found)
    # the pattern does catch what it is there for, and not the port itself
    assert _FORBIDDEN_IMPORT.search('    from glow_tts_tpu.utils import x')
    assert _FORBIDDEN_IMPORT.search('import jax.numpy as jnp')
    assert not _FORBIDDEN_IMPORT.search('from glow_tts_tpu_torch import x')
