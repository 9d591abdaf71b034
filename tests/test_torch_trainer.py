"""The port's ``Trainer`` and CLI (``glow_tts_tpu_torch/training/
trainer.py``, ``cli.py``) on the CPU at ``tiny_config`` size, dropout on
at ``tiny_config``'s rates, on pattern archives the tests write: 12 train
patterns (3 batches of 4 an epoch, so 4 steps cross an epoch and a resume
at step 2 is mid-epoch) and 6 eval patterns (a batch of 4 and a ragged 2).

* 4 steps against 2, a new ``Trainer(initial_step=0)``, 2 more: the same
  batches in the same order, and bit-equal weights, moments, count,
  generator state and logged losses.
* 3 steps against a hand loop of ``make_train_step`` over the trainer's
  own loader: bit-equal weights.
* ``evaluate()`` on JAX-initialised weights, restored from a checkpoint
  into a trainer whose ActNorm was initialised (so its packed weights are
  stale unless the restore drops them), against the JAX package's mean
  ``make_eval_step`` losses over the JAX loader's eval batches (rtol 2e-5,
  as ``test_torch_train_step.py`` holds losses) and its diagonality.
* Ctrl-C and SIGTERM inside the loop leave ``S_<step>.pt`` at the current
  step; a NaN loss raises ``FloatingPointError`` at the logging interval.
* ``train_main``/``infer_main`` with ``--device cpu`` write checkpoints,
  logs and NPY files, and ``--profile`` that is not ``START:STOP`` exits
  with a usage error; without ``--device`` (CUDA by default) they raise
  here, where CUDA is absent, as ``Trainer(device='cuda')`` does.
"""

import dataclasses
import os
import signal
import types

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from glow_tts_tpu import text as jtext
from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu.data import loader as jloader
from glow_tts_tpu.data import patterns as jpatterns
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.trainer import \
    attention_diagonality as jax_diagonality
from glow_tts_tpu_torch.cli import infer_main, train_main
from glow_tts_tpu_torch.config import save_config
from glow_tts_tpu_torch.data.loader import DataLoader
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, initial_state_dict
from glow_tts_tpu_torch.training.checkpoint import CheckpointManager
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import batch_to_device, make_train_step
from glow_tts_tpu_torch.training.trainer import RUN_SEED, Trainer
from glow_tts_tpu_torch.utils.logging import MemoryWriter
from glow_tts_tpu_torch.weights import load_jax_params, load_state_dict
from tests.helpers import tiny_config
from tests.torch_patterns import (trainer_config, write_inference_tsv,
                                  write_pattern_archive)
from tests.torch_port_helpers import jax_model, port_config

LOSS_RTOL = 2e-5
DIAGONALITY_ATOL = 1e-6
MAX_MEL = 128


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    jcfg = tiny_config()
    path = str(tmp_path_factory.mktemp('archives'))
    write_pattern_archive(os.path.join(path, 'train'), 12, jcfg.sound, 0)
    write_pattern_archive(os.path.join(path, 'eval'), 6, jcfg.sound, 1)
    write_inference_tsv(os.path.join(path, 'sentences.tsv'),
                        ['The birch canoe slid.', 'Glue the sheet.'])
    return path


def _config(root, run, **train):
    train = {'num_workers': 2, 'max_step': 4, 'checkpoint_save_interval': 2,
             'logging_interval': 2, 'evaluation_interval': 4,
             'inference_interval': 100, **train}
    cfg = trainer_config(port_config(tiny_config()), root, **train)
    return dataclasses.replace(
        cfg, checkpoint_path=os.path.join(root, run, 'ckpt'),
        log_path=os.path.join(root, run, 'log'),
        inference_path=os.path.join(root, run, 'inf'))


def _trainer(root, run, initial_step=0, **train):
    return Trainer(_config(root, run, **train), initial_step=initial_step,
                   device='cpu', max_mel_length=MAX_MEL,
                   writers={'train': MemoryWriter(), 'eval': MemoryWriter()})


def _recorded(trainer, before=None, after=None):
    """The batches ``trainer`` steps on, recorded as they arrive.
    ``before(call)`` runs before the step (it may raise), ``after(call,
    metrics)`` after it (it may raise, or return the metrics to use)."""
    seen, step = [], trainer.train_step

    def wrapped(batch):
        seen.append({key: value.clone() for key, value in batch.items()})
        if before is not None:
            before(len(seen))
        metrics = step(batch)
        if after is not None:
            metrics = after(len(seen), metrics) or metrics
        return metrics

    trainer.train_step = wrapped
    return seen


def _assert_same_state(a, b):
    for (name, x), (_, y) in zip(a.model.named_parameters(),
                                 b.model.named_parameters()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(a.model), b.optimizer.state_dict(b.model)
    assert sa['count'] == sb['count']
    for key in ('mu', 'nu'):
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_resume_repeats_the_uninterrupted_run(root):
    whole = _trainer(root, 'whole')
    seen_whole = _recorded(whole)
    whole.train()

    first = _trainer(root, 'resumed', max_step=2)
    seen = _recorded(first)
    first.train()
    assert first.checkpoints.steps() == [2]
    second = _trainer(root, 'resumed')
    assert (second.step, second.seed) == (2, RUN_SEED)
    seen_after = _recorded(second)
    second.train()
    seen += seen_after

    assert len(seen_whole) == len(seen) == 4
    for a, b in zip(seen_whole, seen):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    # the epoch boundary is crossed: step 4 takes a batch of epoch 1
    assert not torch.equal(seen[3]['mels'], seen[0]['mels'])
    _assert_same_state(whole, second)
    assert second.optimizer.count == 4
    for kind in ('train', 'eval'):
        got = {tag: first.writers[kind].scalars.get(tag, [])
               + second.writers[kind].scalars.get(tag, [])
               for tag in whole.writers[kind].scalars}
        want = dict(whole.writers[kind].scalars)
        for tag in ('step_time_sec', 'mel_frames_per_sec'):   # host clocks
            got.pop(tag, None), want.pop(tag, None)
        assert got == want, kind
    assert [step for step, _ in whole.writers['train'].scalars['Loss/total']
            ] == [2, 4]
    assert [step for step, _ in whole.writers['eval'].scalars['Loss/total']
            ] == [0, 4]


def test_trainer_steps_as_a_hand_loop_over_its_loader(root):
    trainer = _trainer(root, 'steps', max_step=3)
    trainer.train()

    cfg = trainer.config
    model = load_state_dict(GlowTTS(cfg), initial_state_dict(cfg, RUN_SEED)
                            ).prepare(fold=False)
    first = next(iter(DataLoader(trainer.train_dataset, trainer.collater,
                                 cfg.train.batch_size, shuffle=False,
                                 prefetch=0)))
    model.data_dependent_init(torch.from_numpy(first['mels']),
                              torch.from_numpy(first['mel_lengths']))
    step = make_train_step(cfg, model,
                           make_optimizer(cfg, model.parameters()),
                           seed=RUN_SEED,
                           generator=torch.Generator().manual_seed(RUN_SEED))
    for batch in list(trainer.train_loader(0))[:3]:
        step(batch_to_device(batch, 'cpu'))
    for (name, a), (_, b) in zip(trainer.model.named_parameters(),
                                 model.named_parameters()):
        assert torch.equal(a, b), name


def _jax_eval_means(jcfg, params, eval_path):
    model = jstep.build_model(jcfg)
    eval_step = jstep.make_eval_step(jcfg, model)
    run = jax.jit(lambda p, b: eval_step(types.SimpleNamespace(params=p), b))
    loader = jloader.DataLoader(
        jpatterns.PatternDataset(eval_path),
        jcollate.TrainCollater(jcfg, jtext.Tokenizer()), 4, shuffle=False,
        prefetch=0, drop_last=False)
    totals, count = {}, 0
    for batch in loader:
        losses, outputs = run(params, batch)
        values = {f'Loss/{tag}': float(v) for tag, v in losses.items()}
        values['Alignment/diagonality'] = jax_diagonality(
            np.asarray(outputs['attentions']), batch['token_lengths'],
            batch['mel_lengths'])
        for tag, value in values.items():
            totals[tag] = totals.get(tag, 0.0) + value
        count += 1
    assert count == 2                       # 4 + a ragged 2
    return {tag: value / count for tag, value in totals.items()}


def test_evaluate_on_restored_jax_weights_matches_jax(root):
    jcfg, _, params, _ = jax_model(seed=2)
    source = _trainer(root, 'jax-weights')
    load_jax_params(source.model, params, source.config)
    source.save_checkpoint()                  # S_0.pt

    trainer = _trainer(root, 'jax-weights')   # ActNorm set, then restored
    assert trainer.checkpoints.steps() == [0]
    got = trainer.evaluate()
    want = _jax_eval_means(jcfg, params,
                           trainer.config.train.eval_pattern.path)
    assert sorted(got) == sorted(want)
    for tag in ('Loss/mle', 'Loss/duration', 'Loss/total'):
        np.testing.assert_allclose(got[tag], want[tag], rtol=LOSS_RTOL,
                                   err_msg=tag)
    np.testing.assert_allclose(got['Alignment/diagonality'],
                               want['Alignment/diagonality'],
                               atol=DIAGONALITY_ATOL)
    assert trainer.writers['eval'].scalars['Loss/total'] == [
        (0, got['Loss/total'])]
    free = trainer.free_running
    assert free['mels'].shape == (2, MAX_MEL, jcfg.sound.mel_dim)
    assert torch.isfinite(free['mels']).all()


@pytest.mark.parametrize('how,saved', [
    ('raise', [2]), ('raise mid-update', []),
    (signal.SIGINT, [3]), (signal.SIGTERM, [3])],
    ids=['raise', 'raise-mid-update', 'sigint', 'sigterm'])
def test_an_interrupt_saves_the_step_reached(root, how, saved):
    """A KeyboardInterrupt raised in the loop saves the step reached, or
    nothing if it lands after an update that ``self.step`` does not count
    yet; Ctrl-C and SIGTERM let the current step finish, then save it."""
    trainer = _trainer(root, f'interrupt-{how}', max_step=10,
                       checkpoint_save_interval=100, logging_interval=100,
                       evaluation_interval=100)

    def before(call):
        if call == 3:                        # 2 steps done, the third due
            if how == 'raise':
                raise KeyboardInterrupt
            if how != 'raise mid-update':
                os.kill(os.getpid(), how)

    def after(call, metrics):
        if call == 3 and how == 'raise mid-update':
            raise KeyboardInterrupt

    handlers = [signal.getsignal(signum)
                for signum in (signal.SIGTERM, signal.SIGINT)]
    _recorded(trainer, before, after)
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    assert handlers == [signal.getsignal(signum)
                        for signum in (signal.SIGTERM, signal.SIGINT)]
    assert trainer.checkpoints.steps() == saved
    if saved:
        payload = trainer.checkpoints.restore(0)
        assert payload['Steps'] == payload['Optimizer']['count'] == saved[0]
        for key, value in trainer.model.state_dict().items():
            assert torch.equal(payload['Model'][key], value), key


def test_a_nan_loss_stops_at_the_logging_interval(root):
    trainer = _trainer(root, 'nan', max_step=10, logging_interval=2,
                       checkpoint_save_interval=100, evaluation_interval=100)

    def poison(call, metrics):
        if call == 1:
            return {**metrics, 'total': torch.tensor(float('nan'))}

    _recorded(trainer, after=poison)
    with pytest.raises(FloatingPointError, match='step 2'):
        trainer.train()
    assert trainer.step == 2


def test_cli_trains_and_serves_on_the_cpu(root, tmp_path):
    cfg = _config(root, 'cli', max_step=2, evaluation_interval=2,
                  inference_interval=2, num_workers=1,
                  inference_pattern_file_in_train=os.path.join(
                      root, 'sentences.tsv'))
    hp = str(tmp_path / 'hp.yaml')
    save_config(cfg, hp)
    train_main(['-hp', hp, '--device', 'cpu'])
    assert CheckpointManager(cfg.checkpoint_path).steps() == [2]
    for kind in ('Train', 'Evaluation'):
        assert any(name.startswith('events.') for name in os.listdir(
            os.path.join(cfg.log_path, kind))), kind
    in_train = os.path.join(cfg.inference_path, 'Step-2', 'NPY', 'Mel')
    assert sorted(os.listdir(in_train)) == ['L0.npy', 'L1.npy']

    out = str(tmp_path / 'served')
    infer_main(['-c', cfg.checkpoint_path, '-f',
                os.path.join(root, 'sentences.tsv'), '-o', out,
                '--device', 'cpu'])
    infer_main(['-c', cfg.checkpoint_path, '-s', '2', '-t', 'Hello there.',
                '-o', out, '--device', 'cpu'])
    mels = sorted(os.listdir(os.path.join(out, 'NPY', 'Mel')))
    assert mels == ['L0.npy', 'L1.npy', 'Sentence_0.npy']
    for name in mels:
        mel = np.load(os.path.join(out, 'NPY', 'Mel', name))
        assert mel.shape[0] == cfg.sound.mel_dim and np.isfinite(mel).all()
    for argv in (['--profile', '2'], ['--profile', 'a:b']):
        with pytest.raises(SystemExit):
            train_main(['-hp', hp, '--device', 'cpu', *argv])
    wav_out = str(tmp_path / 'wavs')
    infer_main(['-c', cfg.checkpoint_path, '-t', 'Hi.', '-wav', '-o',
                wav_out, '--device', 'cpu'])
    rate, audio = wavfile.read(os.path.join(wav_out, 'WAV', 'Sentence_0.wav'))
    frames = np.load(os.path.join(wav_out, 'NPY', 'Mel',
                                  'Sentence_0.npy')).shape[1]
    assert rate == cfg.sound.sample_rate and audio.dtype == np.int16
    assert audio.shape == (cfg.sound.frame_shift * (frames - 1),)


def test_the_entry_points_default_to_cuda(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA is available: the default device runs')
    cfg = _config(root, 'cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        Trainer(cfg)
    hp = str(tmp_path / 'hp.yaml')
    save_config(cfg, hp)
    with pytest.raises(RuntimeError, match='CUDA'):
        train_main(['-hp', hp])
    CheckpointManager(str(tmp_path / 'ckpt'), cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        infer_main(['-c', str(tmp_path / 'ckpt'), '-t', 'Hello there.'])
