"""The alignment curriculum in the port's checkpoints and ``Trainer``
(``glow_tts_tpu_torch/training/checkpoint.py``, ``training/trainer.py``) on
the CPU at ``tiny_config`` size, dropout on, on pattern archives the tests
write (12 train patterns, 3 batches of 4 an epoch; the space is token 2,
the pause):

* ``em_stats`` through a checkpoint file bit for bit; the JAX package's
  rule across configurations: a checkpoint without them under an 'em'
  config warns and resumes with zeros, one with them under another config
  warns and drops them;
* the step function ``Trainer`` runs at each step: the variant of
  (step < ``Alignment_Warmup_Steps``, step < ``Decoder_Freeze_Steps``),
  built only where a count asks for it, with the mode's path;
* an 'em' run with the warmup and the freeze over its first 2 steps: 4
  steps against 1, a new ``Trainer`` that restores ``S_1.pt``, and 3 more,
  across the release: bit-equal weights, moments, count, generator state,
  ``em_stats`` and logged losses (``distill`` among them), the decoder
  bit-unchanged over the frozen steps.
"""

import dataclasses
import os
import warnings

import pytest
import torch

from glow_tts_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    restored_em_stats,
                                                    train_payload)
from glow_tts_tpu_torch.training.optim import RAdam
from glow_tts_tpu_torch.training.step import init_em_stats
from glow_tts_tpu_torch.training.trainer import Trainer
from glow_tts_tpu_torch.utils.logging import MemoryWriter
from tests.helpers import tiny_config
from tests.torch_patterns import trainer_config, write_pattern_archive
from tests.torch_port_helpers import port_config

MAX_MEL = 128
PAUSE = 2


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    jcfg = tiny_config()
    path = str(tmp_path_factory.mktemp('archives'))
    write_pattern_archive(os.path.join(path, 'train'), 12, jcfg.sound, 0)
    write_pattern_archive(os.path.join(path, 'eval'), 6, jcfg.sound, 1)
    return path


def _config(root, run, **train):
    train = {'num_workers': 2, 'max_step': 4, 'checkpoint_save_interval': 1,
             'logging_interval': 1, 'evaluation_interval': 4,
             'inference_interval': 100, 'anchor_pause_tokens': (PAUSE,),
             **train}
    cfg = trainer_config(port_config(tiny_config()), root, **train)
    return dataclasses.replace(
        cfg, checkpoint_path=os.path.join(root, run, 'ckpt'),
        log_path=os.path.join(root, run, 'log'),
        inference_path=os.path.join(root, run, 'inf'))


def _trainer(cfg, initial_step=0):
    return Trainer(cfg, initial_step=initial_step, device='cpu',
                   max_mel_length=MAX_MEL,
                   writers={'train': MemoryWriter(), 'eval': MemoryWriter()})


def _caught(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        result = fn()
    return result, [str(w.message) for w in caught]


EM = dict(alignment_warmup_mode='em', alignment_warmup_steps=2,
          decoder_freeze_steps=2)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _payload(cfg, em_stats):
    """A checkpoint's payload (of a small stand-in model) with
    ``em_stats`` or without."""
    model = torch.nn.Linear(2, 2)
    optimizer = RAdam(model.parameters(), learning_rate=1e-3, base=10)
    return train_payload(model, optimizer, 3, 0, 0,
                         torch.Generator().manual_seed(0), em_stats)


def test_em_stats_round_trip_bit_equal(root, tmp_path):
    cfg = _config(root, 'unused', **EM)
    gen = torch.Generator().manual_seed(4)
    stats = tuple(torch.randn(s.shape, generator=gen)
                  for s in init_em_stats(cfg))
    manager = CheckpointManager(str(tmp_path))
    manager.save(3, _payload(cfg, stats))
    payload = manager.restore()
    (got, messages) = _caught(lambda: restored_em_stats(payload, cfg, 'cpu'))
    assert messages == []
    assert len(got) == 3
    for a, b in zip(got, stats):
        assert torch.equal(a, b)


def test_no_em_stats_under_an_em_config_warns_and_starts_from_zeros(root):
    cfg = _config(root, 'unused', **EM)
    payload = _payload(cfg, None)
    assert 'em_stats' not in payload
    got, messages = _caught(lambda: restored_em_stats(payload, cfg, 'cpu'))
    assert len(messages) == 1 and 'no em_stats' in messages[0]
    for a, b in zip(got, init_em_stats(cfg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('train', [
    {}, {'alignment_warmup_mode': 'em'},
    {'alignment_warmup_mode': 'anchored', 'alignment_warmup_steps': 5},
    {'decoder_freeze_steps': 5}])
def test_em_stats_under_another_config_warn_and_are_dropped(root, train):
    cfg = _config(root, 'unused', **train)
    payload = _payload(cfg, init_em_stats(cfg))
    got, messages = _caught(lambda: restored_em_stats(payload, cfg, 'cpu'))
    assert got is None
    assert len(messages) == 1 and 'does not use' in messages[0]
    got, messages = _caught(lambda: restored_em_stats(
        _payload(cfg, None), cfg, 'cpu'))
    assert got is None and messages == []


# --------------------------------------------------------------------------
# the step chosen per iteration
# --------------------------------------------------------------------------

@pytest.mark.parametrize('train,variants,expected', [
    ({}, set(), ['plain'] * 4),
    ({'alignment_warmup_steps': 3}, {(True, False)},
     [(True, False)] * 3 + ['plain']),
    ({'decoder_freeze_steps': 2}, {(False, True)},
     [(False, True)] * 2 + ['plain'] * 2),
    ({'alignment_warmup_steps': 1, 'decoder_freeze_steps': 3,
      'alignment_warmup_mode': 'anchored'},
     {(True, True), (True, False), (False, True)},
     [(True, True), (False, True), (False, True), 'plain']),
    ({'alignment_warmup_steps': 3, 'decoder_freeze_steps': 1,
      'alignment_warmup_mode': 'em'},
     {(True, True), (True, False), (False, True)},
     [(True, True), (True, False), (True, False), 'plain']),
])
def test_the_step_chosen_per_iteration(root, train, variants, expected):
    trainer = _trainer(_config(root, 'choice', max_step=0, **train))
    assert set(trainer.curriculum_steps) == variants
    names = {id(fn): key for key, fn in trainer.curriculum_steps.items()}
    names[id(trainer.train_step)] = 'plain'
    assert [names[id(trainer.step_function(step))]
            for step in range(4)] == expected
    assert (trainer.em.stats is not None) == (
        train.get('alignment_warmup_mode') == 'em')


@pytest.mark.parametrize('mode,mas_calls', [('linear', 0), ('anchored', 1),
                                            ('em', 2)])
def test_warmup_steps_take_the_modes_path(root, mode, mas_calls, monkeypatch):
    """One warmup step, then a plain one: the MAS calls per step are the
    mode's (2 for 'em': the anchored and the table score), then one."""
    from glow_tts_tpu_torch.ops import mas
    calls = []
    original = mas.maximum_path_reference

    def counting(*args, **kwargs):
        calls.append(len(calls))
        return original(*args, **kwargs)

    # what maximum_path runs on a CPU tensor
    monkeypatch.setattr(mas, 'maximum_path_reference', counting)
    cfg = _config(root, f'path-{mode}', max_step=2, alignment_warmup_steps=1,
                  alignment_warmup_mode=mode, checkpoint_save_interval=100,
                  evaluation_interval=100)
    trainer = _trainer(cfg)
    counts = []
    for key, fn in [*trainer.curriculum_steps.items(),
                    ('plain', trainer.train_step)]:
        def wrapped(batch, fn=fn, key=key):
            before = len(calls)
            metrics = fn(batch)
            counts.append((key, len(calls) - before, 'distill' in metrics))
            return metrics
        if key == 'plain':
            trainer.train_step = wrapped
        else:
            trainer.curriculum_steps[key] = wrapped
    trainer.train()
    assert counts == [((True, False), mas_calls, mode == 'em'),
                      ('plain', 1, False)]


# --------------------------------------------------------------------------
# resume across the release
# --------------------------------------------------------------------------

def _assert_same(a, b):
    for (name, x), (_, y) in zip(a.model.named_parameters(),
                                 b.model.named_parameters()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(a.model), b.optimizer.state_dict(b.model)
    assert sa['count'] == sb['count']
    for key in ('mu', 'nu'):
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for x, y in zip(a.em.stats, b.em.stats):
        assert torch.equal(x, y)


def test_em_resume_across_the_release_repeats_the_uninterrupted_run(root):
    whole = _trainer(_config(root, 'whole', **EM))
    decoder = {name: p.detach().clone() for name, p in
               whole.model.layer_Dict['Decoder'].named_parameters()}
    after_freeze = {}
    step = whole.step_function

    def watch(n):
        if n == 2:       # both frozen steps done
            after_freeze.update({
                name: p.detach().clone() for name, p in
                whole.model.layer_Dict['Decoder'].named_parameters()})
        return step(n)

    whole.step_function = watch
    whole.train()
    assert whole.checkpoints.steps() == [1, 2, 3, 4]
    for name, value in decoder.items():
        assert torch.equal(after_freeze[name], value), name
    assert any(not torch.equal(p, decoder[name]) for name, p in
               whole.model.layer_Dict['Decoder'].named_parameters())
    assert float(whole.em.stats[0].sum()) > 0

    first = _trainer(_config(root, 'resumed', max_step=1, **EM))
    first.train()
    second = _trainer(_config(root, 'resumed', **EM))
    assert second.step == 1
    second.train()
    _assert_same(whole, second)
    assert second.optimizer.count == 4
    logged = whole.writers['train'].scalars
    assert [s for s, _ in logged['Loss/distill']] == [1, 2]
    got = {tag: first.writers['train'].scalars.get(tag, [])
           + second.writers['train'].scalars.get(tag, [])
           for tag in logged}
    for tag in ('Loss/total', 'Loss/mle', 'Loss/duration', 'Loss/distill',
                'Loss/grad_norm'):
        assert got[tag] == logged[tag], tag
    payload = second.checkpoints.restore(4)
    for a, b in zip(payload['em_stats'], whole.em.stats):
        assert torch.equal(a, b)
