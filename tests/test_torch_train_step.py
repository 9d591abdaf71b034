"""The port's train step (``glow_tts_tpu_torch/training/step.py::
make_train_step``: forward with dropout → MAS → losses → backward → clip →
RAdam/Noam update) against the JAX package's ``make_train_step`` on the
same parameters and batch at ``tiny_config`` size on the CPU, with every
dropout rate 0 (the two frameworks draw other bits), for the JAX decoder
backends ``'flax'`` and ``'mega_interpret'`` (its Pallas train kernels in
interpret mode).

Tolerances (both sides f32, sums in another order): ``total``, ``mle`` and
``duration`` rtol 2e-5 over three steps; ``grad_norm`` rtol 2e-4; the first
step's gradients leaf by leaf rtol 2e-4 / atol 2e-5, as the JAX package
holds its own two backends together (``tests/test_coupling_train.py``).
The batch's MAS path is the same on both sides (a near-tie could move
whole frames; such a seed would be replaced, not tolerated).

Also: the port's ``Dropout`` keeps the statistical contract of
``tests/test_dropout.py``; the same seed and generator state give the same
step, another seed another; the duration loss reaches no encoder
parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.models.layers import Dropout
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import (compute_losses, flow_seed,
                                              make_train_step)
from glow_tts_tpu_torch.weights import (gradients_as_jax_params,
                                        load_jax_params)
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_port_helpers import (port_config, t, with_backend,
                                      with_dropout)

LOSS_RTOL = 2e-5
NORM_RTOL = 2e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 3


def _tensors(batch):
    return {key: t(value) for key, value in batch.items()}


def _port(cfg, params):
    pcfg = port_config(cfg)
    model = load_jax_params(PortGlowTTS(pcfg), params, pcfg)
    return pcfg, model.prepare(fold=False)


@pytest.fixture(scope='module', params=['flax', 'mega_interpret'])
def both(request):
    """Three steps of both packages from the same perturbed parameters
    (a live end conv) on one batch, all dropout rates 0."""
    cfg = with_backend(with_dropout(tiny_config(), 0.0), request.param)
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

    pcfg, port = _port(cfg, params)
    train_step = make_train_step(pcfg, port, make_optimizer(
        pcfg, port.parameters()), seed=0)
    got_metrics, got_grads = [], None
    for _ in range(STEPS):
        metrics = train_step(_tensors(batch))
        got_metrics.append({key: float(v) for key, v in metrics.items()})
        if got_grads is None:
            got_grads = gradients_as_jax_params(port, pcfg)
    return dict(ref_metrics=ref_metrics, got_metrics=got_metrics,
                ref_grads=ref_grads, got_grads=got_grads,
                ref_params=state.params, port=port, pcfg=pcfg)


@pytest.mark.parametrize('key,rtol', [('total', LOSS_RTOL),
                                      ('mle', LOSS_RTOL),
                                      ('duration', LOSS_RTOL),
                                      ('grad_norm', NORM_RTOL)])
def test_three_step_trajectory_matches_jax(both, key, rtol):
    ref = [m[key] for m in both['ref_metrics']]
    got = [m[key] for m in both['got_metrics']]
    assert set(both['got_metrics'][0]) == {'mle', 'duration', 'total',
                                           'grad_norm'}
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=rtol)
    if key == 'total':
        assert got[-1] < got[0]


def test_first_step_gradients_match_jax_leaf_by_leaf(both):
    ref = dict(jax.tree_util.tree_leaves_with_path(both['ref_grads']))
    got = dict(jax.tree_util.tree_leaves_with_path(both['got_grads']))
    assert set(got) == set(ref) and len(ref) > 100
    for path, value in ref.items():
        assert got[path].shape == value.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path], np.asarray(value), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # every leaf carries a gradient, the 4x4 mixing weights included
    assert all(np.abs(value).max() > 0 for value in got.values())


def test_parameters_after_three_steps_match_jax(both):
    """rtol 5e-4 / atol 5e-5 as ``test_full_train_step_mega_matches_flax_
    rate0`` holds the JAX package's own two backends after one step."""
    from glow_tts_tpu_torch.weights import reference_to_params
    got = dict(jax.tree_util.tree_leaves_with_path(
        reference_to_params(both['port'].state_dict(), both['pcfg'])))
    for path, value in jax.tree_util.tree_leaves_with_path(
            both['ref_params']):
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=5e-4,
                                   atol=5e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _dropout_step(seed, generator_seed, steps=2):
    cfg = tiny_config()                          # dropout 0.5 / 0.1 / 0.05
    batch = synthetic_batch(cfg, batch=4)
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(3), batch)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)
    pcfg, port = _port(cfg, params)
    train_step = make_train_step(
        pcfg, port, make_optimizer(pcfg, port.parameters()), seed=seed,
        generator=torch.Generator().manual_seed(generator_seed))
    metrics = [train_step(_tensors(batch)) for _ in range(steps)]
    return metrics, port


def test_same_seed_and_generator_give_the_same_steps():
    a, port_a = _dropout_step(5, 9)
    b, port_b = _dropout_step(5, 9)
    for ma, mb in zip(a, b):
        for key in ma:
            assert torch.equal(ma[key], mb[key]), key
    for (name, pa), (_, pb) in zip(port_a.named_parameters(),
                                   port_b.named_parameters()):
        assert torch.equal(pa, pb), name
    c, _ = _dropout_step(6, 9)                   # other flow masks
    d, _ = _dropout_step(5, 10)                  # other encoder masks
    assert not torch.equal(a[0]['total'], c[0]['total'])
    assert not torch.equal(a[0]['total'], d[0]['total'])
    assert all(torch.isfinite(v) for m in a for v in m.values())


def test_flow_seed_is_an_int32_that_moves_with_the_step():
    seeds = [flow_seed(123, step) for step in range(1000)]
    assert len(set(seeds)) == 1000
    assert all(-2 ** 31 <= s < 2 ** 31 for s in seeds)
    assert min(seeds) < 0 < max(seeds)
    assert flow_seed(123, 4) != flow_seed(124, 4)


def test_duration_loss_sends_no_gradient_into_the_encoder():
    """The duration predictor reads detached encodings."""
    cfg = tiny_config()
    batch = _tensors(synthetic_batch(cfg, batch=4))
    _, state = jstep.create_train_state(
        cfg, jax.random.PRNGKey(0), synthetic_batch(cfg, batch=4))
    pcfg, port = _port(cfg, jax.tree_util.tree_map(np.array, state.params))
    outputs = port(batch['tokens'], batch['token_lengths'], batch['mels'],
                   batch['mel_lengths'], deterministic=False, seed=1,
                   generator=torch.Generator().manual_seed(0))
    compute_losses(pcfg, outputs, batch)['duration'].backward()
    with_grad = {name for name, p in port.named_parameters()
                 if p.grad is not None and p.grad.abs().max() > 0}
    assert with_grad and all('Duration_Predictor' in name
                             for name in with_grad), sorted(with_grad)[:5]
    predictor = [name for name, _ in port.named_parameters()
                 if 'Duration_Predictor' in name]
    assert with_grad == set(predictor)


@pytest.mark.parametrize('rate', [0.05, 0.1, 0.5])
def test_dropout_statistics(rate):
    x = torch.ones(256, 1024)
    y = Dropout(rate)(x, False, torch.Generator().manual_seed(3)).numpy()
    # 262,144 samples: sigma of the drop fraction < 1e-3
    assert abs(float((y == 0).mean()) - rate) < 0.006
    np.testing.assert_allclose(y[y != 0], 1.0 / (1.0 - rate), rtol=1e-5)


def test_dropout_is_a_function_of_the_generator_state():
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(5))
    drop = Dropout(0.1)
    a = drop(x, False, torch.Generator().manual_seed(7))
    b = drop(x, False, torch.Generator().manual_seed(7))
    c = drop(x, False, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(7)
    assert not torch.equal(drop(x, False, gen), drop(x, False, gen))


def test_dropout_identity_cases_and_the_missing_generator():
    x = torch.arange(12.0).reshape(3, 4)
    assert Dropout(0.0)(x, False) is x
    assert Dropout(0.5)(x, True) is x
    with pytest.raises(ValueError, match='Generator'):
        Dropout(0.5)(x, False)
    with pytest.raises(ValueError, match='rate'):
        Dropout(1.0)
    # the gradient passes through the kept elements, scaled
    leaf = (x + 1.0).requires_grad_()
    y = Dropout(0.5)(leaf, False, torch.Generator().manual_seed(1))
    y.sum().backward()
    assert torch.equal(leaf.grad, (y != 0).float() * 2.0)
