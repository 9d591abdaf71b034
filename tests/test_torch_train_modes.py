"""Training in the conditioned modes (SE with the look-up table, SE with
GE2E, PE, GR): the PyTorch port against the JAX package at
``tiny_config`` size on the CPU, on the same converted parameters (a
nonzero end conv) and the same numpy batch, every dropout rate 0 (the two
frameworks draw other bits):

* ``TrainCollater``'s batches equal to the JAX collater's, element for
  element (speakers, the GE2E slices of the training mels, the pitch on
  the truncated mel's timeline);
* the conditioned ActNorm init against ``create_train_state``'s, and, with
  every coupling live, each step's ActNorm output whitened over the valid
  frames of the input that the conditioned steps before it give;
* the first step's losses (``mle``, ``duration``, GR's ``speaker``,
  ``total``), ``grad_norm`` and gradients leaf by leaf, and a 3-step
  trajectory, with the tolerances of ``tests/test_torch_train_step.py``;
* the GE2E encoder frozen: not the optimiser's, bit-unchanged after the
  steps, its gradient zero on both sides (so absent from the norm);
* the plain train-direction flow stack with both a per-sample ``cond`` and
  a pitch operand against JAX's train pair (its reference and its Pallas
  kernels in interpret mode): z, logdet, ``dx``, every weight gradient,
  ``dw_pitch``, ``dcond`` and ``dpitch``, as ``test_torch_coupling_grad.py``
  holds them;
* a GR ``Trainer`` run (pattern archives with speakers and pitch) that
  resumes from ``S_2.pt`` and repeats the uninterrupted run bit for bit,
  and a GE2E ``Trainer`` that takes its encoder from
  ``Speaker_Embedding.GE2E.Checkpoint_Path``; the CLI trains GR.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glow_tts_tpu import text as jtext
from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch import text as ttext
from glow_tts_tpu_torch.cli import train_main
from glow_tts_tpu_torch.config import save_config
from glow_tts_tpu_torch.data import collate as tcollate
from glow_tts_tpu_torch.models.decoder import squeeze
from glow_tts_tpu_torch.models.glow_tts import (GlowTTS, random_state_dict)
from glow_tts_tpu_torch.models.layers import sequence_mask
from glow_tts_tpu_torch.ops import coupling_grad as TCG
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import make_train_step
from glow_tts_tpu_torch.training.trainer import Trainer
from glow_tts_tpu_torch.utils.logging import MemoryWriter
from glow_tts_tpu_torch.weights import (GE2E_PREFIX, gradients_as_jax_params,
                                        load_jax_params, load_state_dict)
from tests.helpers import synthetic_batch
from tests.torch_patterns import trainer_config, write_pattern_archive
from tests.torch_port_helpers import (MODES, mode_config, port_config, t,
                                      with_dropout)

LOSS_RTOL = 2e-5
NORM_RTOL = 2e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DDI_ATOL = 1e-5
STEPS = 3
# the flow stack against JAX's train pair (tests/test_torch_coupling_grad.py)
Z_TOL = dict(rtol=2e-5, atol=2e-5)
LD_TOL = dict(rtol=2e-5, atol=2e-4)
STACK_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _tensors(batch):
    return {key: t(value) for key, value in batch.items()}


@pytest.fixture(scope='module', params=MODES)
def both(request):
    """Three train steps of both packages in one mode from the same
    perturbed parameters on one batch, all dropout rates 0; the JAX train
    step compiled once."""
    mode = request.param
    cfg = with_dropout(mode_config(mode), 0.0)
    batch = synthetic_batch(cfg, batch=4)
    model, state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jax_make_optimizer(cfg).init(params))
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}

    def loss_fn(p):
        outputs = model.apply({'params': p}, deterministic=False,
                              rngs={'dropout': jax.random.PRNGKey(1)},
                              **jbatch)
        return jstep.compute_losses(cfg, outputs, jbatch)['total']

    ref_grads = jax.grad(loss_fn)(state.params)
    step = jax.jit(jstep.make_train_step(cfg, model))
    ref_metrics = []
    for _ in range(STEPS):
        state, metrics = step(state, jbatch)
        ref_metrics.append({key: float(v) for key, v in metrics.items()})

    pcfg = port_config(cfg)
    port = load_jax_params(GlowTTS(pcfg), params, pcfg).prepare(fold=False)
    before = {name: p.detach().clone() for name, p in port.named_parameters()}
    optimizer = make_optimizer(pcfg, port.parameters())
    train_step = make_train_step(pcfg, port, optimizer, seed=0)
    got_metrics, got_grads = [], None
    for _ in range(STEPS):
        metrics = train_step(_tensors(batch))
        got_metrics.append({key: float(v) for key, v in metrics.items()})
        if got_grads is None:
            got_grads = gradients_as_jax_params(port, pcfg)
    return dict(mode=mode, ref_metrics=ref_metrics, got_metrics=got_metrics,
                ref_grads=ref_grads, got_grads=got_grads, port=port,
                optimizer=optimizer, before=before)


def _items(cfg, seed, n=5):
    """Training items with what every mode reads: pitch tracks shorter and
    longer than their mels, mels of odd lengths (truncated to the
    squeeze)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list('ABCDEFGHIJ KLMNOP'))
    items = []
    for i in range(n):
        frames = int(rng.integers(5, 60))
        items.append({
            'text': ''.join(rng.choice(letters, int(rng.integers(3, 20)))
                            ).strip() or 'A',
            'mel': rng.standard_normal((frames, cfg.sound.mel_dim)
                                       ).astype(np.float32),
            'speaker_id': int(rng.integers(cfg.speaker_embedding
                                           .num_speakers)),
            'pitch': rng.random(frames + int(rng.integers(-4, 5))
                                ).astype(np.float32)})
    return items


@pytest.mark.parametrize('mode', ('Vanilla',) + MODES)
def test_train_collater_matches_jax(mode):
    cfg = mode_config(mode)
    items = _items(cfg, 3)
    ref = jcollate.TrainCollater(cfg, jtext.Tokenizer(), seed=5)(items)
    got = tcollate.TrainCollater(port_config(cfg), ttext.Tokenizer(),
                                 seed=5)(items)
    assert set(got) == set(ref)
    expected = {'Vanilla': set(), 'SE-LUT': {'speakers'},
                'SE-GE2E': {'speakers', 'mels_for_ge2e'}, 'PE': set(),
                'GR': {'speakers', 'pitches'}}[mode]
    assert set(got) - {'tokens', 'token_lengths', 'mels',
                       'mel_lengths'} == expected
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize('mode', MODES)
def test_conditioned_actnorm_init_matches_jax(mode):
    """``create_train_state`` initialises the JAX model on a batch with its
    conditioning; the port, given the same other parameters with its
    ActNorms at zero, must arrive at the same ``logs``/``bias`` in every
    step."""
    cfg = mode_config(mode)
    batch = synthetic_batch(cfg, rng=np.random.default_rng(4), batch=4)
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(4), batch)
    params = jax.tree_util.tree_map(np.array, state.params)
    pcfg = port_config(cfg)
    port = load_jax_params(GlowTTS(pcfg), params, pcfg)
    flows = port.layer_Dict['Decoder'].layer_Dict['Flows']
    expected = [(s.layers[0].logs.detach().clone(),
                 s.layers[0].bias.detach().clone()) for s in flows]
    with torch.no_grad():
        for s in flows:
            s.layers[0].logs.zero_()
            s.layers[0].bias.zero_()
    tb = _tensors(batch)
    port.prepare().data_dependent_init(
        tb['mels'], tb['mel_lengths'], speakers=tb.get('speakers'),
        mels_for_ge2e=tb.get('mels_for_ge2e'), pitches=tb.get('pitches'))
    assert any(logs.abs().max() > 0.05 for logs, _ in expected)
    for k, (s, (logs, bias)) in enumerate(zip(flows, expected)):
        np.testing.assert_allclose(s.layers[0].logs.detach().numpy(),
                                   logs.numpy(), rtol=0, atol=DDI_ATOL,
                                   err_msg=f'logs of step {k}')
        np.testing.assert_allclose(s.layers[0].bias.detach().numpy(),
                                   bias.numpy(), rtol=0, atol=DDI_ATOL,
                                   err_msg=f'bias of step {k}')


@pytest.mark.parametrize('mode', MODES)
def test_conditioned_init_whitens_each_step_of_live_couplings(mode):
    """With every coupling live (random weights), each step's input comes
    through the conditioned steps before it: the init must run them with
    the batch's conditioning rows and pitch, so that every ActNorm output
    has zero mean and unit variance over the valid frames of that input."""
    pcfg = port_config(mode_config(mode))
    port = load_state_dict(GlowTTS(pcfg),
                           random_state_dict(pcfg, 2)).prepare()
    batch = _tensors(synthetic_batch(mode_config(mode),
                                     rng=np.random.default_rng(5), batch=4))
    args = dict(speakers=batch.get('speakers'),
                mels_for_ge2e=batch.get('mels_for_ge2e'),
                pitches=batch.get('pitches'))
    port.data_dependent_init(batch['mels'], batch['mel_lengths'], **args)
    mels, lengths = batch['mels'], batch['mel_lengths']
    speaker, prosody, _ = port.conditions(mels, lengths, args['speakers'],
                                          args['mels_for_ge2e'])
    decoder = port.layer_Dict['Decoder']
    mask = sequence_mask(lengths, mels.shape[1])
    pitch = decoder._squeezed_pitch(args['pitches'], mask)
    x, mask = squeeze(mels, mask, pcfg.decoder.num_squeeze)
    cond = decoder.conditioning(x.shape[0], speaker, prosody,
                                pitch is not None)
    n = mask.sum()
    with torch.no_grad():
        for k, step in enumerate(decoder.layer_Dict['Flows']):
            y, _ = step.layers[0](x, mask)
            mean = (y * mask).sum(dim=(0, 1)) / n
            var = (y * y * mask).sum(dim=(0, 1)) / n - mean ** 2
            np.testing.assert_allclose(mean.numpy(), 0, atol=1e-4,
                                       err_msg=f'step {k}')
            np.testing.assert_allclose(var.numpy(), 1, atol=1e-3,
                                       err_msg=f'step {k}')
            x, _ = step(x, mask, cond=cond[k], pitch=pitch)


def test_first_step_losses_and_grad_norm_match_jax(both):
    ref, got = both['ref_metrics'][0], both['got_metrics'][0]
    expected = {'mle', 'duration', 'total', 'grad_norm'} | (
        {'speaker'} if both['mode'] == 'GR' else set())
    assert set(got) == set(ref) == expected
    for key, value in ref.items():
        rtol = NORM_RTOL if key == 'grad_norm' else LOSS_RTOL
        np.testing.assert_allclose(got[key], value, rtol=rtol, err_msg=key)


def test_first_step_gradients_match_jax_leaf_by_leaf(both):
    ref = dict(jax.tree_util.tree_leaves_with_path(both['ref_grads']))
    got = dict(jax.tree_util.tree_leaves_with_path(both['got_grads']))
    assert set(got) == set(ref) and len(ref) > 100
    for path, value in ref.items():
        assert got[path].shape == value.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path], np.asarray(value), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    live = [path for path in got if 'ge2e' not in jax.tree_util.keystr(path)]
    # every leaf but the frozen encoder's carries a gradient: the
    # conditioning convs and vectors, the classifier's
    assert all(np.abs(got[path]).max() > 0 for path in live), [
        jax.tree_util.keystr(p) for p in live if np.abs(got[p]).max() == 0]


@pytest.mark.parametrize('key,rtol', [('total', LOSS_RTOL),
                                      ('mle', LOSS_RTOL),
                                      ('duration', LOSS_RTOL),
                                      ('speaker', LOSS_RTOL),
                                      ('grad_norm', NORM_RTOL)])
def test_three_step_trajectory_matches_jax(both, key, rtol):
    if key not in both['ref_metrics'][0]:
        assert key not in both['got_metrics'][0]
        return
    ref = [m[key] for m in both['ref_metrics']]
    got = [m[key] for m in both['got_metrics']]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol)
    if key == 'total':
        assert got[-1] < got[0]


def test_ge2e_is_frozen(both):
    """The GE2E encoder's parameters are not the optimiser's (no update,
    no decay, no moments, no part of the norm) and are bit-unchanged after
    the steps; JAX's gradient of them is zero (``stop_gradient``)."""
    port, optimizer = both['port'], both['optimizer']
    frozen = {name for name, p in port.named_parameters()
              if name.startswith(GE2E_PREFIX)}
    assert bool(frozen) == (both['mode'] == 'SE-GE2E')
    assert frozen == {name for name, p in port.named_parameters()
                      if not p.requires_grad}
    names = set(optimizer.state_dict(port)['mu'])
    assert names == {name for name, _ in port.named_parameters()} - frozen
    moved = 0
    for name, p in port.named_parameters():
        if name in frozen:
            assert p.grad is None and torch.equal(p, both['before'][name])
        else:
            moved += not torch.equal(p, both['before'][name])
    # (an attention key bias has no gradient: softmax ignores a shift)
    assert moved > 0.9 * (len(both['before']) - len(frozen))
    for path, value in jax.tree_util.tree_leaves_with_path(
            both['ref_grads']):
        if 'ge2e' in jax.tree_util.keystr(path):
            assert np.abs(np.asarray(value)).max() == 0


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('oracle', ['twin', 'pallas'])
def test_stack_backward_with_cond_and_pitch_matches_jax(rate, oracle):
    """``flow_stack_train`` on CPU tensors (its plain version, by
    autograd) with both a per-sample ``cond`` and a pitch operand, against
    JAX's reference or its Pallas train pair in interpret mode."""
    s_steps, n, k, ch, c = 3, 2, 5, 16, 16
    rng = np.random.default_rng(8)
    lengths = [11, 7, 4]
    b, frames = len(lengths), max(lengths)
    mask = (np.arange(frames)[None, :, None]
            < np.array(lengths)[:, None, None]).astype(np.float32)
    x = rng.standard_normal((b, frames, c)).astype(np.float32) * mask
    shapes = TCG.weight_shapes(s_steps, c, ch, n, k, ps=2)
    weights = {key: (rng.standard_normal(shape) * .2).astype(np.float32)
               for key, shape in shapes.items()}
    weights['ld_const'] = (rng.standard_normal(s_steps) * .1
                           ).astype(np.float32)
    cond = (rng.standard_normal((s_steps, n, b, 2 * ch)) * .2
            ).astype(np.float32)
    pitch = rng.standard_normal((b, frames, 2)).astype(np.float32) * mask
    zt = rng.standard_normal((b, frames, c)).astype(np.float32)
    ld_weight = np.arange(1., b + 1.).astype(np.float32)
    fn = (JCG.flow_stack_train_reference if oracle == 'twin' else
          lambda *a, **kw: JCG.fused_flow_stack_train(*a, interpret=True,
                                                      **kw))

    def jax_loss(w_, x_, c_, p_):
        z, ld = fn(x_, jnp.asarray(mask), w_, c_, p_, seed=jnp.int32(-9),
                   dropout_rate=rate)
        return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight), (z, ld)

    (_, (z_ref, ld_ref)), ref = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        {key: jnp.asarray(v) for key, v in weights.items()}, jnp.asarray(x),
        jnp.asarray(cond), jnp.asarray(pitch))

    tw = {key: t(v).requires_grad_() for key, v in weights.items()}
    tx, tc, tp = (t(v).requires_grad_() for v in (x, cond, pitch))
    z, ld = TCG.flow_stack_train(tx, t(mask), tw, tc, tp, seed=-9,
                                 dropout_rate=rate)
    (torch.sum(z * t(zt)) + 0.7 * torch.sum(ld * t(ld_weight))).backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref),
                               **Z_TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref),
                               **LD_TOL)
    for key in weights:
        np.testing.assert_allclose(tw[key].grad.numpy(),
                                   np.asarray(ref[0][key]), **STACK_GRAD_TOL,
                                   err_msg=f'd{key}')
    for name, leaf, value in (('dx', tx, ref[1]), ('dcond', tc, ref[2]),
                              ('dpitch', tp, ref[3])):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(value),
                                   **STACK_GRAD_TOL, err_msg=name)
    assert np.abs(tw['w_pitch'].grad.numpy()).max() > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

MAX_MEL = 128


@pytest.fixture(scope='module')
def archives(tmp_path_factory):
    """12 train patterns (3 batches of 4 an epoch) and 6 eval patterns,
    each with a speaker id and a pitch track."""
    sound = mode_config('GR').sound
    path = str(tmp_path_factory.mktemp('archives'))
    write_pattern_archive(os.path.join(path, 'train'), 12, sound, 0)
    write_pattern_archive(os.path.join(path, 'eval'), 6, sound, 1)
    return path


def _trainer_config(root, run, mode='GR', **train):
    train = {'num_workers': 2, 'max_step': 4, 'checkpoint_save_interval': 2,
             'logging_interval': 2, 'evaluation_interval': 4,
             'inference_interval': 100, **train}
    cfg = trainer_config(port_config(mode_config(mode)), root, **train)
    return dataclasses.replace(
        cfg, checkpoint_path=os.path.join(root, run, 'ckpt'),
        log_path=os.path.join(root, run, 'log'),
        inference_path=os.path.join(root, run, 'inf'))


def _trainer(cfg, initial_step=0):
    return Trainer(cfg, initial_step=initial_step, device='cpu',
                   max_mel_length=MAX_MEL,
                   writers={'train': MemoryWriter(), 'eval': MemoryWriter()})


def test_gr_trainer_resume_repeats_the_uninterrupted_run(archives):
    """4 steps against 2, a new ``Trainer`` that restores ``S_2.pt``, and 2
    more, in GR mode with dropout on: the same weights, moments, count,
    generator state and logged losses (the speaker term among them) bit
    for bit; an evaluation with its free-running decode ran."""
    whole = _trainer(_trainer_config(archives, 'whole'))
    whole.train()
    _trainer(_trainer_config(archives, 'resumed', max_step=2)).train()
    resumed = _trainer(_trainer_config(archives, 'resumed'))
    assert resumed.step == 2
    resumed.train()
    for (name, a), (_, b) in zip(whole.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(a, b), name
    sa = whole.optimizer.state_dict(whole.model)
    sb = resumed.optimizer.state_dict(resumed.model)
    assert sa['count'] == sb['count'] == 4
    for key in ('mu', 'nu'):
        for name in sa[key]:
            assert torch.equal(sa[key][name], sb[key][name]), (key, name)
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())
    logged_a = whole.writers['train'].scalars
    logged_b = resumed.writers['train'].scalars
    assert 'Loss/speaker' in logged_a
    for tag in ('Loss/total', 'Loss/mle', 'Loss/duration', 'Loss/speaker'):
        assert logged_a[tag][-1] == logged_b[tag][-1], tag
    assert whole.free_running is not None
    assert torch.isfinite(whole.free_running['mels']).all()


def test_ge2e_trainer_takes_its_encoder_from_the_checkpoint_path(archives):
    """SE-GE2E: a new run loads the pre-trained encoder from
    ``Speaker_Embedding.GE2E.Checkpoint_Path`` (a torch state dict under
    the reference's own module path), trains with it frozen, and its
    checkpoints carry it, so a resumed run does not read the path."""
    cfg = _trainer_config(archives, 'ge2e', 'SE-GE2E', max_step=2)
    donor = random_state_dict(cfg, 11)
    ge2e = {'GE2E.' + key[len(GE2E_PREFIX):]: value
            for key, value in donor.items() if key.startswith(GE2E_PREFIX)}
    path = os.path.join(archives, 'ge2e.pt')
    torch.save({'Model': ge2e}, path)
    cfg = dataclasses.replace(cfg, speaker_embedding=dataclasses.replace(
        cfg.speaker_embedding, ge2e=dataclasses.replace(
            cfg.speaker_embedding.ge2e, checkpoint_path=path)))
    trainer = _trainer(cfg)
    trainer.train()
    state = trainer.model.state_dict()
    for key, value in donor.items():
        if key.startswith(GE2E_PREFIX):
            assert torch.equal(state[key], value), key
    os.remove(path)
    assert _trainer(cfg).step == 2         # restored: the path is not read


def test_cli_trains_gr_on_the_cpu(archives):
    cfg = _trainer_config(archives, 'cli', max_step=2,
                          evaluation_interval=2)
    os.makedirs(os.path.join(archives, 'cli'), exist_ok=True)
    path = os.path.join(archives, 'cli', 'hp.yaml')
    save_config(cfg, path)
    with open(path, encoding='utf-8') as f:
        assert yaml.safe_load(f)['mode'] == 'GR'
    train_main(['-hp', path, '--device', 'cpu'])
    assert os.path.exists(os.path.join(cfg.checkpoint_path, 'S_2.pt'))
