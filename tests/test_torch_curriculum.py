"""The port's alignment curriculum (``glow_tts_tpu_torch/models/glow_tts.py``:
the 'linear', 'anchored' and 'em' warmup paths; ``training/losses.py``: the
distillation loss; ``training/step.py``: the step's variants and the decoder
freeze) against the JAX package on the CPU at ``tests/helpers.py::
tiny_config`` size, inputs from a numpy seed.

Tolerances, each for the reason given:
* the linear and the anchored path: equal (the anchored path is MAS on a
  score both frameworks compute in the same f32 order of a few terms);
* ``fit_token_table``: rtol 1e-6 / atol 1e-6 (sums of products of 0/1 and
  f32, in another order);
* ``table_prior_log_likelihood``: rtol 1e-5 / atol 1e-5 (two ``einsum``s
  whose low bits differ between the frameworks);
* ``em_alignment_path``: the path equal on data whose optimum is clear
  (per-token-id signatures, as ``tests/test_model.py::
  test_em_table_recovers_true_path`` builds them), the statistics and the
  distillation targets rtol 1e-5 / atol 1e-5, the log std through
  ``exp(2·log_std) + mean²`` (= s1/cnt): the variance s1/cnt − mean²
  cancels on such data, so its log carries the einsums' low bits ×300;
* ``prior_distill_loss``: rtol 1e-6;
* the train step, dropout rates 0, three steps per variant (linear,
  anchored, EM, EM + freeze, freeze alone; Vanilla, EM + freeze in GR, and
  Vanilla at ``Num_Squeeze: 1``, MiniSpeech's layout): losses (``distill``
  among them) rtol 2e-5 and ``grad_norm`` 2e-4, as
  ``tests/test_torch_train_step.py`` holds the plain step; the parameters
  and the optimiser's moments after three steps rtol 5e-4 / atol 5e-5;
  ``em_stats`` rtol 1e-5 / atol 1e-4 (sums of up to a batch of z values);
  the paths of every step equal.  The frozen decoder's parameters are bit
  for bit what they were while its moments moved.

Also the port of ``tests/test_model.py::test_em_release_transition_keeps_
lock``: 150 EM + freeze steps, then 30 plain steps, the learned prior's
MAS accuracy above 0.85 before the release and no more than 0.05 below it
after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import glow_tts as jglow
from glow_tts_tpu.training import losses as jlosses
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch.models import glow_tts as pglow
from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.training import losses as plosses
from glow_tts_tpu_torch.training.optim import RAdam, make_optimizer
from glow_tts_tpu_torch.training.step import (EMState, init_em_stats,
                                              make_train_step)
from glow_tts_tpu_torch.weights import load_jax_params, reference_to_params
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_port_helpers import port_config, t, with_dropout

EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 2e-5
NORM_RTOL = 2e-4
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-4)
STEPS = 3
PAUSE = 2
CURRICULUM = {'Alignment_Warmup_Mode': 'em', 'Alignment_Warmup_Steps': 10,
              'Decoder_Freeze_Steps': 10, 'Anchor_Pause_Tokens': [PAUSE],
              'Anchor_Silence_Level': -3.5}


def _train_section(**extra):
    return {'Batch_Size': 8,
            'Learning_Rate': {'Initial': 1.0e-3, 'Base': 100},
            'ADAM': {'Beta1': 0.9, 'Beta2': 0.999, 'Epsilon': 1.0e-6},
            'Weight_Decay': 1.0e-6, 'Gradient_Norm': 5.0, **extra}


def em_lock_corpus(rng, batch=8, n_words=4, mel_dim=8, ragged=False):
    """Words of two 4-frame content tokens and a 4-frame silent pause
    (token 2) with per-token-id mel signatures: the EM table's optimum is
    clear (``tests/test_model.py::_em_lock_corpus``).  With ``ragged``,
    sample b keeps ``n_words - b % n_words`` words."""
    vocab_lo, vocab_hi, dur = 3, 11, 4
    signatures = rng.normal(0.0, 2.0, (vocab_hi, mel_dim)).astype(np.float32)
    t_tok = 3 * n_words
    t_mel = t_tok * dur
    tokens = np.zeros((batch, t_tok), np.int32)
    mels = np.full((batch, t_mel, mel_dim), -4.0, np.float32)
    token_lengths = np.full((batch,), t_tok, np.int32)
    owners = np.repeat(np.arange(t_tok), dur)
    for b in range(batch):
        seq = []
        for _ in range(n_words):
            seq.extend(rng.integers(vocab_lo, vocab_hi, 2).tolist())
            seq.append(PAUSE)
        tokens[b] = seq
        mel = np.where((tokens[b] == PAUSE)[owners][:, None],
                       -4.0, signatures[tokens[b]][owners])
        mels[b] = np.clip(mel + rng.normal(0.0, 0.1, mel.shape), -4.0, 4.0)
        if ragged:
            token_lengths[b] = 3 * (n_words - b % n_words)
    mel_lengths = token_lengths * dur
    valid = np.arange(t_mel)[None, :] < mel_lengths[:, None]
    mels = np.where(valid[..., None], mels, -4.0).astype(np.float32)
    tokens = np.where(np.arange(t_tok)[None, :] < token_lengths[:, None],
                      tokens, 0).astype(np.int32)
    return {'tokens': tokens, 'token_lengths': token_lengths,
            'mels': mels, 'mel_lengths': mel_lengths}, owners


def _masks(token_lengths, mel_lengths, t_tok, t_mel):
    tok = np.arange(t_tok)[None] < np.asarray(token_lengths)[:, None]
    mel = np.arange(t_mel)[None] < np.asarray(mel_lengths)[:, None]
    attn = (tok[:, :, None] & mel[:, None, :]).astype(np.float32)
    return attn, mel[..., None].astype(np.float32), tok[..., None].astype(
        np.float32)


def _ragged_lengths(rng, b, t_tok, t_mel):
    token_lengths = rng.integers(1, t_tok + 1, b).astype(np.int32)
    token_lengths[0] = t_tok
    mel_lengths = np.array([rng.integers(tl, t_mel + 1)
                            for tl in token_lengths], np.int32)
    mel_lengths[1] = t_mel
    return token_lengths, mel_lengths


# --------------------------------------------------------------------------
# the paths and the table, function by function
# --------------------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_linear_path_equals_jax(seed):
    rng = np.random.default_rng(seed)
    token_lengths, mel_lengths = _ragged_lengths(rng, 6, 13, 57)
    attn, _, _ = _masks(token_lengths, mel_lengths, 13, 57)
    ref = np.asarray(jglow.linear_alignment_path(
        jnp.asarray(token_lengths), jnp.asarray(mel_lengths),
        jnp.asarray(attn)))
    got = pglow.linear_alignment_path(t(token_lengths), t(mel_lengths),
                                      t(attn)).numpy()
    np.testing.assert_array_equal(got, ref)
    # complete and monotonic: every valid frame has one token
    np.testing.assert_array_equal(got.sum(axis=1).sum(axis=1), mel_lengths)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_anchored_path_equals_jax(seed):
    """The raw mel timeline is two frames longer than the decoder's, as
    ``num_squeeze`` leaves it: both cut it to the path's frames."""
    rng = np.random.default_rng(seed)
    b, t_tok, t_mel = 6, 11, 40
    token_lengths, mel_lengths = _ragged_lengths(rng, b, t_tok, t_mel)
    attn, _, _ = _masks(token_lengths, mel_lengths, t_tok, t_mel)
    tokens = rng.integers(0, 6, (b, t_tok)).astype(np.int32)
    mels = rng.normal(-2.0, 2.0, (b, t_mel + 2, 8)).astype(np.float32)
    ref = np.asarray(jglow.anchored_alignment_path(
        jnp.asarray(tokens), jnp.asarray(token_lengths), jnp.asarray(mels),
        jnp.asarray(mel_lengths), jnp.asarray(attn), (PAUSE, 4), -2.5,
        'scan'))
    got = pglow.anchored_alignment_path(
        t(tokens), t(token_lengths), t(mels), t(mel_lengths), t(attn),
        (PAUSE, 4), -2.5, maximum_path).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.sum(axis=(1, 2)), mel_lengths)


def _table_problem(seed, ragged=True):
    """A ragged batch with a monotonic path and random z: the table's
    inputs."""
    rng = np.random.default_rng(seed)
    b, t_tok, t_mel, c, vocab = 5, 9, 30, 8, 13
    token_lengths, mel_lengths = _ragged_lengths(rng, b, t_tok, t_mel)
    if not ragged:
        token_lengths[:], mel_lengths[:] = t_tok, t_mel
    attn, mel_mask, _ = _masks(token_lengths, mel_lengths, t_tok, t_mel)
    tokens = rng.integers(0, vocab, (b, t_tok)).astype(np.int32)
    path = np.asarray(jglow.linear_alignment_path(
        jnp.asarray(token_lengths), jnp.asarray(mel_lengths),
        jnp.asarray(attn)))
    z = (rng.standard_normal((b, t_mel, c)) * mel_mask).astype(np.float32)
    return tokens, path, z, mel_mask, attn, vocab


@pytest.mark.parametrize('ragged', [True, False])
def test_fit_token_table_matches_jax(ragged):
    """Past a sample's length the path's column is zero: both argmaxes take
    token 0 there, and the mask removes it."""
    tokens, path, z, mel_mask, _, vocab = _table_problem(3, ragged)
    ref = jglow.fit_token_table(jnp.asarray(tokens), jnp.asarray(path),
                                jnp.asarray(z), jnp.asarray(mel_mask), vocab)
    got = pglow.fit_token_table(t(tokens), t(path), t(z), t(mel_mask), vocab)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **EXACT_TOL)
    # every valid frame counted once
    assert float(got[0].sum()) == float(mel_mask.sum())


def test_table_score_matches_jax():
    tokens, path, z, mel_mask, attn, vocab = _table_problem(4)
    stats = jglow.fit_token_table(jnp.asarray(tokens), jnp.asarray(path),
                                  jnp.asarray(z), jnp.asarray(mel_mask),
                                  vocab)
    # a running sum: some ids unseen (count 0), others pooled
    stats = tuple(0.875 * s + s for s in stats)
    ref = jglow.table_prior_log_likelihood(jnp.asarray(tokens),
                                           jnp.asarray(z), stats,
                                           jnp.asarray(attn))
    got = pglow.table_prior_log_likelihood(
        t(tokens), t(z), tuple(t(s) for s in stats), t(attn))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SCORE_TOL)


@pytest.mark.parametrize('ragged', [False, True])
def test_em_path_matches_jax(ragged):
    """On the EM-lockable corpus, with running statistics from a previous
    batch: the path equal, the statistics and the targets to 1e-5."""
    rng = np.random.default_rng(5)
    batch, _ = em_lock_corpus(rng, ragged=ragged)
    prev, _ = em_lock_corpus(rng)
    t_tok, t_mel = batch['tokens'].shape[1], batch['mels'].shape[1]
    attn, mel_mask, _ = _masks(batch['token_lengths'], batch['mel_lengths'],
                               t_tok, t_mel)
    z = (batch['mels'] + rng.normal(0.0, 0.05, batch['mels'].shape)
         ).astype(np.float32) * mel_mask
    prev_path = np.asarray(jglow.linear_alignment_path(
        jnp.asarray(prev['token_lengths']), jnp.asarray(prev['mel_lengths']),
        jnp.asarray(_masks(prev['token_lengths'], prev['mel_lengths'],
                           t_tok, t_mel)[0])))
    stats = [np.asarray(s) for s in jglow.fit_token_table(
        jnp.asarray(prev['tokens']), jnp.asarray(prev_path),
        jnp.asarray(prev['mels']), jnp.ones((8, t_mel, 1)), 13)]
    args = dict(vocab=13, pause_tokens=(PAUSE,), silence_level=-3.5,
                stats_decay=0.875)
    ref = jglow.em_alignment_path(
        jnp.asarray(batch['tokens']), jnp.asarray(batch['token_lengths']),
        jnp.asarray(batch['mels']), jnp.asarray(batch['mel_lengths']),
        jnp.asarray(z), jnp.asarray(attn), jnp.asarray(mel_mask),
        tuple(jnp.asarray(s) for s in stats), mas_backend='scan', **args)
    got = pglow.em_alignment_path(
        t(batch['tokens']), t(batch['token_lengths']), t(batch['mels']),
        t(batch['mel_lengths']), t(z), t(attn), t(mel_mask),
        tuple(t(s) for s in stats), mas_fn=maximum_path, **args)
    path, new_stats, mean, log_std = got
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref[0]))
    for g, r in zip(new_stats, ref[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SCORE_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref[2]), **SCORE_TOL)
    # the table's variance s1/cnt - mean² cancels (here it is ~1/300 of
    # s1/cnt), so the log std is held through the sum it comes from:
    # exp(2 log_std) + mean² = s1/cnt (where the 1e-4 floor does not bite)
    np.testing.assert_allclose(
        (torch.exp(2 * log_std) + mean ** 2).numpy(),
        np.exp(2 * np.asarray(ref[3])) + np.asarray(ref[2]) ** 2,
        **SCORE_TOL)
    assert not any(x.requires_grad for x in (path, mean, log_std))


def test_em_path_goes_through_the_mas_function_twice():
    rng = np.random.default_rng(6)
    batch, _ = em_lock_corpus(rng)
    t_tok, t_mel = batch['tokens'].shape[1], batch['mels'].shape[1]
    attn, mel_mask, _ = _masks(batch['token_lengths'], batch['mel_lengths'],
                               t_tok, t_mel)
    scores = []

    def recording(log_p, tl, ml):
        scores.append(log_p.clone())
        return maximum_path(log_p, tl, ml)

    pglow.em_alignment_path(
        t(batch['tokens']), t(batch['token_lengths']), t(batch['mels']),
        t(batch['mel_lengths']), t(batch['mels']), t(attn), t(mel_mask),
        tuple(s for s in init_em_stats(port_config(tiny_config()))), 35,
        (PAUSE,), -3.5, 0.875, recording)
    assert len(scores) == 2                # the anchored and the table score
    assert not torch.equal(scores[0], scores[1])


def test_prior_distill_loss_matches_jax():
    rng = np.random.default_rng(7)
    shape = (4, 9, 8)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(4)]
    token_mask = (np.arange(9)[None] < np.array([9, 5, 1, 7])[:, None]
                  )[..., None].astype(np.float32)
    ref = jlosses.prior_distill_loss(*map(jnp.asarray, arrays),
                                     jnp.asarray(token_mask))
    got = plosses.prior_distill_loss(*map(t, arrays), t(token_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# --------------------------------------------------------------------------
# the optimiser's freeze
# --------------------------------------------------------------------------

def test_freeze_zeroes_updates_not_moments():
    """A frozen parameter keeps its value (weight decay included) while its
    gradient counts in the clipping norm and moves its moments; the other
    parameters' updates are what they are without the freeze."""
    gen = torch.Generator().manual_seed(0)
    start = [torch.randn(s, generator=gen) + 1.0
             for s in [(3, 4), (5,), (2, 2, 2)]]

    def run(frozen_index):
        params = [torch.nn.Parameter(value.clone()) for value in start]
        opt = RAdam(params, learning_rate=1e-2, base=10, weight_decay=0.1,
                    max_grad_norm=0.5)
        frozen = [params[frozen_index]] if frozen_index is not None else []
        norms = []
        for step in range(6):
            for i, p in enumerate(params):
                p.grad = torch.randn(p.shape, generator=gen) * (i + 1)
            norms.append(opt.step(frozen))
        return params, opt, norms

    gen.manual_seed(1)
    free, opt_free, norms_free = run(None)
    gen.manual_seed(1)
    held, opt_held, norms_held = run(1)
    assert torch.equal(held[1].detach(), start[1])
    for i in (0, 2):
        assert torch.equal(held[i], free[i])
    assert not torch.equal(free[1].detach(), start[1])
    for a, b in zip(norms_free, norms_held):
        assert torch.equal(a, b)
    for key in ('mu', 'nu'):
        for a, b in zip(getattr(opt_free, key), getattr(opt_held, key)):
            assert torch.equal(a, b)
    assert (opt_held.mu[1] != 0).all()


# --------------------------------------------------------------------------
# the train step's variants against JAX's
# --------------------------------------------------------------------------

VARIANTS = {
    'linear': dict(linear_alignment=True),
    'anchored': dict(anchored_alignment=True),
    'em': dict(em_alignment=True),
    'em+freeze': dict(em_alignment=True, freeze_decoder=True),
    'freeze': dict(freeze_decoder=True),
}


def _radam_moments(opt_state):
    """(mu, nu) trees of the JAX optimiser's state."""
    radam = opt_state.inner_states['train'].inner_state[1]
    return radam.mu, radam.nu


def _run_variant(mode, variant, squeeze=2):
    """Three steps of one variant in both packages from the same perturbed
    parameters on the EM-lockable batch, dropout rates 0."""
    flags = VARIANTS[variant]
    overrides = {'Train': _train_section(**CURRICULUM)}
    if squeeze != 2:
        base = tiny_config().decoder
        overrides['Decoder'] = {
            'Stack': base.stack, 'Num_Squeeze': squeeze,
            'Num_Split': base.num_split,
            'Affine_Coupling': {
                'Calc_Channels': base.affine_coupling.calc_channels,
                'WaveNet': {'Num_Layers': 2, 'Kernel_Size': 5,
                            'Dropout_Rate': 0.05}}}
    cfg = with_dropout(tiny_config(mode, **overrides), 0.0)
    rng = np.random.default_rng(11)
    batch, _ = em_lock_corpus(rng)
    if mode != 'Vanilla':
        extra = synthetic_batch(cfg, rng, batch=8, t_tok=12, t_mel=48)
        batch.update({key: extra[key] for key in ('speakers', 'pitches',
                                                  'mels_for_ge2e')
                      if key in extra})
    model, state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)
    prng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * prng.standard_normal(
            p.shape).astype(np.float32), state.params)
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jax_make_optimizer(cfg).init(params))
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}
    step = jax.jit(jstep.make_train_step(cfg, model, **flags))
    em = flags.get('em_alignment', False)

    @jax.jit
    def path_of(params, em_stats):
        return model.apply(
            {'params': params}, deterministic=False,
            rngs={'dropout': jax.random.PRNGKey(1)},
            linear_alignment=flags.get('linear_alignment', False),
            anchored_alignment=flags.get('anchored_alignment', False),
            em_alignment=em, em_stats=em_stats if em else None,
            **jbatch)['attentions']

    ref_metrics, ref_paths = [], []
    for _ in range(STEPS):
        ref_paths.append(np.asarray(path_of(state.params, state.em_stats)))
        state, metrics = step(state, jbatch)
        ref_metrics.append({key: float(v) for key, v in metrics.items()})

    pcfg = port_config(cfg)
    port = load_jax_params(GlowTTS(pcfg), params, pcfg).prepare(fold=False)
    decoder_before = {name: p.detach().clone() for name, p in
                      port.layer_Dict['Decoder'].named_parameters()}
    optimizer = make_optimizer(pcfg, port.parameters())
    em_state = EMState(init_em_stats(pcfg))
    paths = []

    def recording(log_p, tl, ml):
        result = maximum_path(log_p, tl, ml)
        paths.append(result)
        return result

    train_step = make_train_step(pcfg, port, optimizer, seed=0,
                                 mas_fn=recording, em_state=em_state, **flags)
    tensors = {key: t(value) for key, value in batch.items()}
    got_metrics, got_paths = [], []
    for _ in range(STEPS):
        outputs = {}
        original = port.forward

        def keep(*args, **kwargs):
            result = original(*args, **kwargs)
            outputs.update(result)
            return result

        port.forward = keep
        try:
            metrics = train_step(tensors)
        finally:
            del port.forward
        got_paths.append(outputs['attentions'].numpy())
        got_metrics.append({key: float(v) for key, v in metrics.items()})
    return dict(cfg=cfg, pcfg=pcfg, state=state, ref_metrics=ref_metrics,
                ref_paths=ref_paths, got_metrics=got_metrics,
                got_paths=got_paths, port=port, optimizer=optimizer,
                em_state=em_state, decoder_before=decoder_before,
                mas_calls=len(paths), flags=flags)


CASES = [('Vanilla', variant, 2) for variant in VARIANTS] + [
    ('GR', 'em+freeze', 2), ('Vanilla', 'em+freeze', 1)]


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{m}-{v}-squeeze{s}' for m, v, s in CASES])
def run(request):
    return _run_variant(*request.param)


def test_step_losses_match_jax(run):
    keys = set(run['ref_metrics'][0])
    assert set(run['got_metrics'][0]) == keys
    assert ('distill' in keys) == bool(run['flags'].get('em_alignment'))
    for key in keys:
        rtol = NORM_RTOL if key == 'grad_norm' else LOSS_RTOL
        ref = [m[key] for m in run['ref_metrics']]
        got = [m[key] for m in run['got_metrics']]
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=key)


def test_step_paths_equal_jax(run):
    for got, ref in zip(run['got_paths'], run['ref_paths']):
        np.testing.assert_array_equal(got, ref)
    flags = run['flags']
    per_step = (0 if flags.get('linear_alignment') else
                2 if flags.get('em_alignment') else 1)
    assert run['mas_calls'] == per_step * STEPS


def test_step_parameters_and_moments_match_jax(run):
    port, pcfg, state = run['port'], run['pcfg'], run['state']
    got = dict(jax.tree_util.tree_leaves_with_path(
        reference_to_params(port.state_dict(), pcfg)))
    for path, value in jax.tree_util.tree_leaves_with_path(state.params):
        np.testing.assert_allclose(got[path], np.asarray(value), **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    moments = run['optimizer'].state_dict(port)
    ref_mu, ref_nu = _radam_moments(state.opt_state)
    for key, ref_tree in (('mu', ref_mu), ('nu', ref_nu)):
        tree = dict(jax.tree_util.tree_leaves_with_path(
            reference_to_params(moments[key], pcfg)))
        leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
        # one scale a tree: the attention's key bias has a gradient of
        # zero, and its moments are rounding noise (~1e-10)
        scale = max(float(np.abs(np.asarray(value)).max())
                    for _, value in leaves)
        for path, value in leaves:
            np.testing.assert_allclose(
                tree[path] / scale, np.asarray(value) / scale, **PARAM_TOL,
                err_msg=key + jax.tree_util.keystr(path))


def test_step_em_stats_match_jax(run):
    if not run['flags'].get('em_alignment'):
        assert run['state'].em_stats is not None      # the config's, unused
        assert all(float(s.abs().sum()) == 0
                   for s in run['em_state'].stats)
        return
    for got, ref in zip(run['em_state'].stats, run['state'].em_stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **STATS_TOL)
    assert float(run['em_state'].stats[0].sum()) > 0


def test_frozen_decoder_is_bit_unchanged_while_its_moments_move(run):
    port = run['port']
    decoder = dict(port.layer_Dict['Decoder'].named_parameters())
    frozen = run['flags'].get('freeze_decoder', False)
    changed = [not torch.equal(decoder[name], before)
               for name, before in run['decoder_before'].items()]
    if frozen:
        assert not any(changed)
        names = {id(p): name for name, p in port.named_parameters()}
        moved = [float(mu.abs().max()) > 0
                 for p, mu in zip(run['optimizer'].params,
                                  run['optimizer'].mu)
                 if names[id(p)].startswith('layer_Dict.Decoder.')]
        assert moved and all(moved)
    else:
        assert any(changed)


# --------------------------------------------------------------------------
# the release transition (tests/test_model.py)
# --------------------------------------------------------------------------

def _learned_prior_accuracy(port, batch, owners):
    with torch.no_grad():
        out = port(batch['tokens'], batch['token_lengths'], batch['mels'],
                   batch['mel_lengths'])
    attn = out['attentions'].numpy()
    return float((attn.argmax(axis=1) == owners[None, :]).mean())


def test_em_release_transition_keeps_lock():
    """150 EM + freeze steps lock the learned prior (MAS accuracy above
    0.85 through the distillation); 30 plain steps after the release keep
    it within 0.05, with finite losses."""
    cfg = tiny_config(Train=_train_section(
        **{**CURRICULUM, 'Alignment_Warmup_Steps': 150,
           'Decoder_Freeze_Steps': 0,
           'Learning_Rate': {'Initial': 3.0e-3, 'Base': 4000}}))
    rng = np.random.default_rng(7)
    batch, owners = em_lock_corpus(rng)
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)
    pcfg = port_config(cfg)
    port = load_jax_params(
        GlowTTS(pcfg), jax.tree_util.tree_map(np.asarray, state.params),
        pcfg).prepare(fold=False)
    optimizer = make_optimizer(pcfg, port.parameters())
    em_state = EMState(init_em_stats(pcfg))
    generator = torch.Generator().manual_seed(0)
    em_step = make_train_step(pcfg, port, optimizer, seed=0,
                              generator=generator, em_alignment=True,
                              freeze_decoder=True, em_state=em_state)
    tensors = {key: t(value) for key, value in batch.items()}
    for _ in range(150):
        em_step(tensors)
    acc_warm = _learned_prior_accuracy(port, tensors, owners)
    assert acc_warm > 0.85, acc_warm
    plain_step = make_train_step(pcfg, port, optimizer, seed=0,
                                 generator=generator)
    for _ in range(30):
        metrics = plain_step(tensors)
        assert torch.isfinite(metrics['total'])
    acc_released = _learned_prior_accuracy(port, tensors, owners)
    assert acc_released > acc_warm - 0.05, (acc_warm, acc_released)


def test_em_step_needs_its_statistics():
    cfg = port_config(tiny_config())
    port = GlowTTS(cfg)
    optimizer = make_optimizer(cfg, port.parameters())
    with pytest.raises(ValueError, match='EMState'):
        make_train_step(cfg, port, optimizer, em_alignment=True)
    with pytest.raises(ValueError, match='EMState'):
        make_train_step(cfg, port, optimizer, em_alignment=True,
                        em_state=EMState())
    stats = init_em_stats(cfg)
    assert [tuple(s.shape) for s in stats] == [(35,), (35, 8), (35, 8)]
    assert all(s.dtype == torch.float32 and not s.any() for s in stats)
