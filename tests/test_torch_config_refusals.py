"""What the port's ``load_config`` does with the YAML keys that change what a
run computes (``glow_tts_tpu_torch/config.py``):

* the alignment curriculum (``Train.Alignment_Warmup_Steps`` with its
  mode, ``Train.Decoder_Freeze_Steps`` and the EM and anchor fields) loads
  as the JAX package loads it, field for field, in either key case
  (``configs/MiniSpeech.yaml`` among them), and an unknown warmup mode
  raises ``ValueError`` as there;
* the compute dtype (``TPU.compute_dtype``, or the reference's
  ``Use_Mixed_Precision`` where the ``TPU`` section names none) loads as the
  JAX package reads it, with no warning, at float32 and bfloat16, and any
  other raises naming ``ROADMAP.md`` A.5; the parallel fields load as the
  JAX package reads them: ``data_parallel`` (0 means all devices) with no
  warning, ``model_parallel`` above 1 with one warning per process naming
  A.7 (tensor parallelism is not ported);
* ``configs/Hyper_Parameters.yaml`` loads at bfloat16 with no warning,
  field by field against the JAX package's config.
"""

import copy
import dataclasses
import os
import warnings

import pytest
import yaml

from glow_tts_tpu.config import load_config as jax_load_config
from glow_tts_tpu_torch import config as tconfig
from glow_tts_tpu_torch.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh(monkeypatch):
    """A process that has warned about nothing yet."""
    monkeypatch.setattr(tconfig, '_WARNED', set())


def _yaml(name):
    with open(os.path.join(REPO, 'configs', name), encoding='utf-8') as f:
        return yaml.safe_load(f)


def _load(data):
    """``load_config(data)`` and the warnings it gave."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        config = load_config(data)
    return config, [str(w.message) for w in caught]


def _fields(port_obj, jax_obj, path=''):
    """(path, port value, JAX value) for every leaf field of the port's
    config (``tests/test_torch_weights.py::_port_fields``, the backend
    compared by name elsewhere)."""
    for f in dataclasses.fields(port_obj):
        if f.name == 'coupling_backend':
            continue
        value = getattr(port_obj, f.name)
        ref = (getattr(jax_obj.tpu, f.name)
               if f.name in TPU_FIELDS else getattr(jax_obj, f.name))
        if dataclasses.is_dataclass(value):
            yield from _fields(value, ref, f'{path}{f.name}.')
        else:
            yield f'{path}{f.name}', value, ref


# the port's fields that the JAX config keeps under ``tpu``
TPU_FIELDS = ('token_bucket', 'mel_bucket', 'compute_dtype', 'param_dtype',
              'inference_dtype', 'data_parallel', 'model_parallel')
CURRICULUM_FIELDS = ('alignment_warmup_steps', 'alignment_warmup_mode',
                     'em_stats_decay', 'em_distill_weight',
                     'anchor_pause_tokens', 'anchor_silence_level',
                     'decoder_freeze_steps')


def test_minispeech_loads_field_for_field_like_jax(fresh):
    """The repo's converged recipe: the EM warmup and the decoder freeze,
    5000 steps each, the space token as the pause, at bfloat16; no
    warning."""
    path = os.path.join(REPO, 'configs', 'MiniSpeech.yaml')
    config, messages = _load(path)
    assert messages == []
    assert config.compute_dtype == 'bfloat16'
    ref = jax_load_config(path)
    fields = list(_fields(config, ref))
    names = [name for name, _, _ in fields]
    assert all(f'train.{key}' in names for key in CURRICULUM_FIELDS)
    assert 'compute_dtype' in names
    for name, value, expected in fields:
        assert value == expected, name
    train = config.train
    assert (train.alignment_warmup_mode, train.alignment_warmup_steps,
            train.decoder_freeze_steps, train.anchor_pause_tokens,
            config.decoder.num_squeeze) == ('em', 5000, 5000, (2,), 1)
    assert train.uses_em_stats


def test_curriculum_defaults_are_the_jax_packages(fresh):
    config, ref = load_config({}), jax_load_config({})
    for key in CURRICULUM_FIELDS:
        assert getattr(config.train, key) == getattr(ref.train, key), key
    assert not config.train.uses_em_stats


@pytest.mark.parametrize('key', ['Alignment_Warmup_Steps',
                                 'Decoder_Freeze_Steps'])
@pytest.mark.parametrize('value', [0, 1, 5000])
@pytest.mark.parametrize('lower', [False, True])
def test_curriculum_keys_load_like_jax(fresh, key, value, lower):
    data = _yaml('Hyper_Parameters.yaml')
    data['TPU']['compute_dtype'] = 'float32'
    data['Train'][key.lower() if lower else key] = value
    data['Train']['Alignment_Warmup_Mode'] = 'anchored'
    data['Train']['Anchor_Pause_Tokens'] = [2, 5]
    config, messages = _load(data)
    assert messages == []
    assert getattr(config.train, key.lower()) == value
    ref = jax_load_config(copy.deepcopy(data))
    for name in CURRICULUM_FIELDS:
        assert getattr(config.train, name) == getattr(ref.train, name), name
    assert config.train.anchor_pause_tokens == (2, 5)


@pytest.mark.parametrize('mode', ['anchor', 'EM', 'Linear'])
def test_typod_warmup_mode_raises_like_jax(fresh, mode):
    data = {'Train': {'Alignment_Warmup_Mode': mode,
                      'Alignment_Warmup_Steps': 10}}
    with pytest.raises(ValueError, match='Alignment_Warmup_Mode'):
        jax_load_config(copy.deepcopy(data))
    with pytest.raises(ValueError, match='Alignment_Warmup_Mode'):
        load_config(data)


def test_shipped_yaml_loads_unchanged_with_one_dtype_warning(fresh):
    """``configs/Hyper_Parameters.yaml`` loads as shipped, at bfloat16, with
    no warning (the dtype warning is gone: the port computes at it); at
    float32 it loads to the same config but for the dtype."""
    path = os.path.join(REPO, 'configs', 'Hyper_Parameters.yaml')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        config = load_config(path)
    assert [str(w.message) for w in caught] == []
    assert (config.compute_dtype, config.param_dtype,
            config.inference_dtype, config.serve_dtype) == (
        'bfloat16', 'float32', 'float32', 'float32')
    data = _yaml('Hyper_Parameters.yaml')
    data['TPU']['compute_dtype'] = 'float32'
    assert load_config(data) == dataclasses.replace(config,
                                                    compute_dtype='float32')
    ref = jax_load_config(path)
    assert (config.mode, config.decoder.stack, config.encoder.channels,
            config.train.batch_size, config.compute_dtype) == (
        ref.mode, ref.decoder.stack, ref.encoder.channels,
        ref.train.batch_size, ref.tpu.compute_dtype)
    assert _load(path)[1] == []


@pytest.mark.parametrize('tpu,extra,expect', [
    # the compute dtype loads as the JAX package reads it, with no warning
    ({'compute_dtype': 'bfloat16'}, {}, 'bfloat16'),
    ({'compute_dtype': 'float16'}, {}, ValueError),
    ({'compute_dtype': 'float32'}, {}, 'float32'),
    ({}, {'Use_Mixed_Precision': True}, 'bfloat16'),
    ({}, {'Use_Mixed_Precision': False}, 'float32'),
    ({'compute_dtype': 'float32'}, {'Use_Mixed_Precision': True}, 'float32'),
    # the parallel fields load as the JAX package reads them, with no
    # warning: neither data nor tensor parallelism warns any longer (the
    # ids are the ones these rows have always had)
    ({'data_parallel': 0, 'model_parallel': 1}, {}, None),
    ({'data_parallel': 1}, {}, None),
    pytest.param({'data_parallel': 2}, {}, None, id='tpu8-extra8-A.7'),
    pytest.param({'model_parallel': 4}, {}, None, id='tpu9-extra9-A.7'),
])
def test_dtype_and_devices_warn_and_load_as_without(fresh, tpu, extra,
                                                    expect):
    data = {'Mode': 'GR', 'TPU': dict(tpu), **extra}
    if expect is ValueError:
        # the port computes at float32 and bfloat16 alone, as the JAX
        # package's kernels do
        with pytest.raises(ValueError, match='A.5'):
            load_config(copy.deepcopy(data))
        return
    config, messages = _load(copy.deepcopy(data))
    ref = jax_load_config(copy.deepcopy(data))
    assert config.compute_dtype == ref.tpu.compute_dtype
    if expect in ('bfloat16', 'float32'):
        assert messages == []
        assert config.compute_dtype == expect
        assert config == dataclasses.replace(load_config({'Mode': 'GR'}),
                                             compute_dtype=expect)
    else:
        assert len(messages) == (0 if expect is None else 1), messages
        if expect:
            assert expect in messages[0]
        assert config == dataclasses.replace(load_config({'Mode': 'GR'}),
                                             **tpu)
        for key, value in tpu.items():
            assert getattr(config, key) == getattr(ref.tpu, key) == value
    assert dataclasses.asdict(config)['mode'] == 'GR'
