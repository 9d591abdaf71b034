"""Checkpoints of the port (``glow_tts_tpu_torch/training/checkpoint.py``,
``RAdam.state_dict``) on the CPU at ``tiny_config`` size.

* The optimiser's state, saved and loaded by parameter name with the
  weights and the encoder generator's state, continues bit-equal.
* ``restore(0)`` restores the highest step, ``restore(n)`` exactly ``n``,
  a missing step raises; a file left under the temporary name by a save
  that died is ignored; ``max_to_keep`` drops the oldest.
* The ``Hyper_Parameters.yaml`` snapshot loads back to an equal ``Config``.
* A trainer's checkpoint is read by both packages: its ``Model`` through
  ``weights.load_reference_checkpoint`` and, converted by the JAX package's
  own importer, by the JAX ``make_eval_step``, which gives the losses the
  port's ``make_eval_step`` gives on an ``Inferencer`` built from the
  checkpoint directory alone (rtol 2e-5, as ``test_torch_train_step.py``
  holds losses); that ``Inferencer`` serves a TSV to NPY files.
"""

import dataclasses
import io
import os
import types

import jax
import numpy as np
import pytest
import torch

from glow_tts_tpu import text as jtext
from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu.data import loader as jloader
from glow_tts_tpu.data import patterns as jpatterns
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.utils.torch_import import convert_reference_state_dict
from glow_tts_tpu_torch.config import load_config
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, random_state_dict
from glow_tts_tpu_torch.training.checkpoint import (SNAPSHOT,
                                                    CheckpointManager)
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import make_eval_step, make_train_step
from glow_tts_tpu_torch.training.trainer import Trainer
from glow_tts_tpu_torch.utils.logging import NullWriter
from glow_tts_tpu_torch.weights import (load_reference_checkpoint,
                                        load_state_dict)
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_patterns import (trainer_config, write_inference_tsv,
                                  write_pattern_archive)
from tests.torch_port_helpers import port_config, t

LOSS_RTOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_eval_losses(jcfg, params, batch):
    """The JAX package's ``make_eval_step`` losses on ``params``."""
    eval_step = jstep.make_eval_step(jcfg, jstep.build_model(jcfg))
    return jax.jit(lambda p, b: eval_step(
        types.SimpleNamespace(params=p), b)[0])(params, batch)


def _train_model(cfg):
    return load_state_dict(GlowTTS(cfg), random_state_dict(cfg, 0)
                           ).prepare(fold=False)


def _steps(cfg, model, optimizer, generator, batch, n):
    step = make_train_step(cfg, model, optimizer, seed=7, generator=generator)
    return [step(batch)['total'].item() for _ in range(n)]


def test_radam_state_round_trip_continues_bit_equal():
    """2 steps, save, 2 steps; against 2 steps, save, load into a fresh
    model and an optimiser over the parameters in another order, 2 steps:
    the same losses, weights, moments and count, bit for bit."""
    jcfg = tiny_config()
    cfg = port_config(jcfg)
    batch = {key: t(value)
             for key, value in synthetic_batch(jcfg, batch=4).items()}
    model = _train_model(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    generator = torch.Generator().manual_seed(7)
    _steps(cfg, model, optimizer, generator, batch, 2)
    buffer = io.BytesIO()
    saved_state = optimizer.state_dict(model)
    torch.save({'Model': model.state_dict(), 'Optimizer': saved_state,
                'generator': generator.get_state()}, buffer)
    assert saved_state['count'] == 2
    names = [name for name, _ in model.named_parameters()]
    for key in ('mu', 'nu'):
        assert sorted(saved_state[key]) == sorted(names)
        assert all(value.device.type == 'cpu'
                   for value in saved_state[key].values())
    losses = _steps(cfg, model, optimizer, generator, batch, 2)

    buffer.seek(0)
    payload = torch.load(buffer, weights_only=True)
    other = _train_model(cfg)
    other_optimizer = make_optimizer(cfg, reversed(list(other.parameters())))
    load_state_dict(other, payload['Model'])
    other.layer_Dict['Decoder'].invalidate()
    other_optimizer.load_state_dict(payload['Optimizer'], other)
    other_generator = torch.Generator()
    other_generator.set_state(payload['generator'])
    assert _steps(cfg, other, other_optimizer, other_generator, batch,
                  2) == losses
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 other.named_parameters()):
        assert torch.equal(a, b), name
    a_state, b_state = optimizer.state_dict(model), \
        other_optimizer.state_dict(other)
    assert a_state['count'] == b_state['count'] == 4
    for key in ('mu', 'nu'):
        for name in names:
            assert torch.equal(a_state[key][name], b_state[key][name]), name


def test_radam_refuses_a_state_of_other_parameters():
    cfg = port_config(tiny_config())
    model = _train_model(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    state = optimizer.state_dict(model)
    name = next(iter(state['mu']))
    del state['mu'][name]
    with pytest.raises(KeyError, match='mu'):
        optimizer.load_state_dict(state, model)
    stranger = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match='not in the model'):
        make_optimizer(cfg, [stranger]).state_dict(model)


def test_restore_takes_the_highest_or_the_exact_step(tmp_path):
    checkpoints = CheckpointManager(str(tmp_path / 'ckpt'))
    assert checkpoints.restore(0) is None and checkpoints.latest_step() is None
    for step in (2, 10, 4):
        checkpoints.save(step, {'Steps': step})
    assert checkpoints.steps() == [2, 4, 10]
    assert checkpoints.restore(0)['Steps'] == 10
    assert checkpoints.restore(4)['Steps'] == 4
    with pytest.raises(FileNotFoundError, match='step 3'):
        checkpoints.restore(3)
    assert sorted(os.listdir(checkpoints.directory)) == [
        'S_10.pt', 'S_2.pt', 'S_4.pt']


def test_a_save_that_died_leaves_the_last_whole_file(tmp_path, monkeypatch):
    checkpoints = CheckpointManager(str(tmp_path))
    checkpoints.save(10, {'Steps': 10})

    def dies_mid_write(payload, f):
        f.write(b'half a checkpoint')
        raise OSError('killed')

    monkeypatch.setattr(torch, 'save', dies_mid_write)
    with pytest.raises(OSError, match='killed'):
        checkpoints.save(12, {'Steps': 12})
    monkeypatch.undo()
    assert os.path.exists(os.path.join(str(tmp_path), 'S_12.pt.tmp'))
    assert checkpoints.steps() == [10]
    assert checkpoints.restore(0)['Steps'] == 10


def test_max_to_keep_drops_the_oldest(tmp_path):
    checkpoints = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        checkpoints.save(step, {'Steps': step})
    assert checkpoints.steps() == [3, 4]


@pytest.mark.parametrize('source', ['tiny', 'yaml'])
def test_snapshot_loads_back_to_an_equal_config(tmp_path, source):
    cfg = (port_config(tiny_config()) if source == 'tiny' else
           load_config(os.path.join(REPO, 'configs',
                                    'Hyper_Parameters.yaml')))
    cfg = dataclasses.replace(cfg, coupling_backend='mega',
                              inference_batch_size=3)
    CheckpointManager(str(tmp_path), cfg)
    snapshot = os.path.join(str(tmp_path), SNAPSHOT)
    assert load_config(snapshot) == cfg
    # written once: a later manager keeps the first run's snapshot
    CheckpointManager(str(tmp_path), dataclasses.replace(cfg, mel_bucket=64))
    assert load_config(snapshot) == cfg


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A trainer's checkpoint at step 2 (dropout on), and an eval batch."""
    jcfg = tiny_config()
    root = str(tmp_path_factory.mktemp('run'))
    write_pattern_archive(os.path.join(root, 'train'), 12, jcfg.sound, 0)
    write_pattern_archive(os.path.join(root, 'eval'), 6, jcfg.sound, 1)
    cfg = trainer_config(port_config(jcfg), root, max_step=2,
                         checkpoint_save_interval=2, logging_interval=2,
                         evaluation_interval=100, inference_interval=100,
                         num_workers=1)
    null = NullWriter()
    trainer = Trainer(cfg, device='cpu', max_mel_length=128,
                      writers={'train': null, 'eval': null})
    trainer.train()
    loader = jloader.DataLoader(
        jpatterns.PatternDataset(cfg.train.eval_pattern.path),
        jcollate.TrainCollater(jcfg, jtext.Tokenizer()), 4, shuffle=False,
        prefetch=0, drop_last=False)
    return jcfg, cfg, trainer, next(iter(loader))


def test_checkpoint_model_loads_into_both_packages(trained):
    jcfg, cfg, trainer, batch = trained
    path = CheckpointManager(cfg.checkpoint_path).path(2)
    state_dict = load_reference_checkpoint(path)
    assert sorted(state_dict) == sorted(trainer.model.state_dict())
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(state_dict[key], value), key

    params = convert_reference_state_dict(state_dict, jcfg)
    ref = jax_eval_losses(jcfg, params, batch)
    served = Inferencer(cfg.checkpoint_path, None, 'cpu', max_mel_length=128)
    assert served.config == cfg
    got = make_eval_step(served.config, served.model)(
        {key: t(value) for key, value in batch.items()})[0]
    for key in ('mle', 'duration', 'total'):
        np.testing.assert_allclose(got[key].item(), float(ref[key]),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_checkpoint_directory_serves_a_tsv(trained, tmp_path):
    _, cfg, trainer, _ = trained
    tsv = write_inference_tsv(str(tmp_path / 'sentences.tsv'), [
        'The birch canoe slid.', 'Glue the sheet.', 'It is easy.'])
    out_dir = str(tmp_path / 'out')
    served = Inferencer(cfg.checkpoint_path, None, 'cpu', batch_size=2,
                        max_mel_length=128, step=2)
    results = served.inference_from_file(tsv, out_dir)
    assert [r['label'] for r in results] == ['L0', 'L1', 'L2']
    for r in results:
        mel = np.load(os.path.join(out_dir, 'NPY', 'Mel', f"{r['label']}.npy"))
        attention = np.load(os.path.join(out_dir, 'NPY', 'Attention',
                                         f"{r['label']}.npy"))
        np.testing.assert_array_equal(mel, r['mel'].T)
        assert mel.shape == (cfg.sound.mel_dim, r['mel'].shape[0])
        np.testing.assert_array_equal(attention, r['attention'])
        assert np.isfinite(mel).all()
    # the same weights handed over as a state dict serve the same mels
    again = Inferencer(trainer.model.state_dict(), cfg, 'cpu', batch_size=2,
                       max_mel_length=128).inference_from_file(tsv)
    for a, b in zip(results, again):
        np.testing.assert_array_equal(a['mel'], b['mel'])
    with pytest.raises(FileNotFoundError, match='step 3'):
        Inferencer(cfg.checkpoint_path, None, 'cpu', step=3)
