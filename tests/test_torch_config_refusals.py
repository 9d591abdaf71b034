"""What the port's ``load_config`` does with the YAML keys it has no field
for and that would change what a run computes (``glow_tts_tpu_torch/
config.py``):

* an alignment curriculum (``Train.Alignment_Warmup_Steps``,
  ``Train.Decoder_Freeze_Steps`` non-zero; ``configs/MiniSpeech.yaml``)
  raises ``NotImplementedError`` naming ``ROADMAP.md`` A.3, where it used to
  load as a plain run;
* a compute dtype other than float32 (``TPU.compute_dtype``, or the
  reference's ``Use_Mixed_Precision``) and more than one device
  (``data_parallel`` or ``model_parallel`` above 1; 0 means all devices)
  warn once per process, and the config is the one loaded without them;
* ``configs/Hyper_Parameters.yaml`` loads unchanged apart from a single
  dtype warning, field by field against the JAX package's config.
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


def test_minispeech_curriculum_is_refused(fresh):
    with pytest.raises(NotImplementedError, match='A.3') as err:
        load_config(os.path.join(REPO, 'configs', 'MiniSpeech.yaml'))
    assert 'Alignment_Warmup_Steps' in str(err.value)


@pytest.mark.parametrize('key', ['Alignment_Warmup_Steps',
                                 'Decoder_Freeze_Steps'])
@pytest.mark.parametrize('value,raises', [(0, False), (1, True),
                                          (5000, True)])
def test_curriculum_keys_raise_when_not_zero(fresh, key, value, raises):
    data = _yaml('Hyper_Parameters.yaml')
    data['Train'][key] = value
    if raises:
        with pytest.raises(NotImplementedError, match='A.3'):
            load_config(data)
    else:
        assert load_config(data) == load_config(_yaml(
            'Hyper_Parameters.yaml'))


def test_lower_case_keys_raise_too(fresh):
    with pytest.raises(NotImplementedError, match='A.3'):
        load_config({'train': {'decoder_freeze_steps': 10}})


def test_shipped_yaml_loads_unchanged_with_one_dtype_warning(fresh):
    path = os.path.join(REPO, 'configs', 'Hyper_Parameters.yaml')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        config = load_config(path)
    messages = [str(w.message) for w in caught]
    assert len(messages) == 1 and 'compute_dtype' in messages[0]
    assert 'A.5' in messages[0]
    data = _yaml('Hyper_Parameters.yaml')
    data['TPU']['compute_dtype'] = 'float32'
    assert load_config(data) == config
    ref = jax_load_config(path)
    assert (config.mode, config.decoder.stack, config.encoder.channels,
            config.train.batch_size) == (ref.mode, ref.decoder.stack,
                                         ref.encoder.channels,
                                         ref.train.batch_size)
    # once per process: loading again warns no more
    assert _load(path)[1] == []


@pytest.mark.parametrize('tpu,extra,warns', [
    ({'compute_dtype': 'bfloat16'}, {}, 'compute_dtype'),
    ({'compute_dtype': 'float16'}, {}, 'compute_dtype'),
    ({'compute_dtype': 'float32'}, {}, None),
    ({}, {'Use_Mixed_Precision': True}, 'compute_dtype'),
    ({}, {'Use_Mixed_Precision': False}, None),
    ({'compute_dtype': 'float32'}, {'Use_Mixed_Precision': True}, None),
    ({'data_parallel': 0, 'model_parallel': 1}, {}, None),
    ({'data_parallel': 1}, {}, None),
    ({'data_parallel': 2}, {}, 'A.7'),
    ({'model_parallel': 4}, {}, 'A.7'),
])
def test_dtype_and_devices_warn_and_load_as_without(fresh, tpu, extra,
                                                    warns):
    data = {'Mode': 'GR', 'TPU': dict(tpu), **extra}
    config, messages = _load(copy.deepcopy(data))
    assert len(messages) == (0 if warns is None else 1), messages
    if warns:
        assert warns in messages[0]
    assert config == load_config({'Mode': 'GR'})
    assert dataclasses.asdict(config)['mode'] == 'GR'
