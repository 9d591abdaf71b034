"""The port's optimiser (``glow_tts_tpu_torch/training/optim.py``: clip by
global norm → reference RAdam → weight decay → modified Noam rate) against
the JAX package's optax chain (``make_optimizer``) on the same parameters
and the same sequence of gradients, made from a numpy seed.

Tolerances: both sides f32; the port's moments come from fused
multiply-adds and its step scalars from numpy float32, so a parameter may
differ by an ulp or two of the update per step: rtol 2e-6 / atol 2e-8 on
parameters of order 1 after up to 12 updates of order 1e-3; the schedule
to rtol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glow_tts_tpu.training import optim as joptim
from glow_tts_tpu_torch.training import optim as toptim
from tests.helpers import tiny_config
from tests.torch_port_helpers import port_config

PARAM_TOL = dict(rtol=2e-6, atol=2e-8)
SHAPES = {'a': (7, 5), 'b': (11,), 'c': (2, 3, 4), 'd': ()}


def _config(**train):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train))


def _trajectory(cfg, steps, grad_scale, seed=0):
    """Both optimisers over ``steps`` updates; yields per step the JAX
    parameters, the port's, and the port's reported gradient norm beside
    optax's."""
    rng = np.random.default_rng(seed)
    params = {key: rng.standard_normal(shape).astype(np.float32)
              for key, shape in SHAPES.items()}
    tx = joptim.make_optimizer(cfg)
    jparams = {key: jnp.asarray(value) for key, value in params.items()}
    opt_state = tx.init(jparams)
    tparams = {key: torch.nn.Parameter(torch.tensor(value))
               for key, value in params.items()}
    opt = toptim.make_optimizer(port_config(cfg), tparams.values())
    for _ in range(steps):
        grads = {key: (grad_scale * rng.standard_normal(shape)
                       ).astype(np.float32) for key, shape in SHAPES.items()}
        jgrads = {key: jnp.asarray(value) for key, value in grads.items()}
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for key, value in grads.items():
            tparams[key].grad = torch.tensor(value)
        norm = opt.step()
        yield jparams, tparams, float(norm), float(optax.global_norm(jgrads))


@pytest.mark.parametrize('grad_scale', [0.05, 3.0])
def test_twelve_step_trajectory_matches_optax(grad_scale):
    """12 updates cross the ``N_sma >= 5`` switch (momentum-only updates
    for t <= 5, rectified from t = 6); at scale 3.0 every step clips
    (norm ≈ 30 against 5.0), at 0.05 none does."""
    cfg = _config()
    clipped = []
    for step, (jp, tp, norm, ref_norm) in enumerate(
            _trajectory(cfg, 12, grad_scale)):
        np.testing.assert_allclose(norm, ref_norm, rtol=1e-6)
        clipped.append(norm >= cfg.train.gradient_norm)
        for key in SHAPES:
            np.testing.assert_allclose(
                tp[key].detach().numpy(), np.asarray(jp[key]), **PARAM_TOL,
                err_msg=f'step {step} param {key}')
    assert all(clipped) if grad_scale > 1 else not any(clipped)


def test_rectification_switches_at_the_sixth_update():
    opt = toptim.make_optimizer(port_config(_config()),
                                [torch.nn.Parameter(torch.zeros(1))])
    used = [opt.rectification(t)[0] for t in range(1, 9)]
    assert used == [False] * 5 + [True] * 3
    # the plain factor undoes the first moment's bias
    assert opt.rectification(1)[2] == pytest.approx(10.0, rel=1e-6)


def test_weight_decay_and_its_absence():
    """With zero gradients only the decay moves a parameter:
    ``p ← p − lr · wd · p``."""
    cfg = _config(weight_decay=0.1)
    p = torch.nn.Parameter(torch.full((3,), 2.0))
    opt = toptim.make_optimizer(port_config(cfg), [p])
    p.grad = torch.zeros(3)
    opt.step()
    lr = toptim.learning_rate_at(port_config(cfg), 0)
    np.testing.assert_allclose(p.detach().numpy(), 2.0 - lr * 0.1 * 2.0,
                               rtol=1e-6)
    for jp, tp, _, _ in _trajectory(cfg, 8, 0.5):
        pass
    for key in SHAPES:
        np.testing.assert_allclose(tp[key].detach().numpy(),
                                   np.asarray(jp[key]), **PARAM_TOL)


@pytest.mark.parametrize('initial,base', [(1e-3, 100), (1e-3, 4000),
                                          (5e-4, 1)])
def test_schedule_matches_jax(initial, base):
    cfg = _config(learning_rate=dataclasses.replace(
        tiny_config().train.learning_rate, initial=initial, base=base))
    port = port_config(cfg)
    for step in (0, 1, 2, 10, 999, 123456):
        np.testing.assert_allclose(
            toptim.learning_rate_at(port, step),
            float(joptim.learning_rate_at(cfg, step)), rtol=1e-6)
    # counts from 0 and clamps to step >= 1: the first two rates are equal
    assert toptim.learning_rate_at(port, 0) == toptim.learning_rate_at(port, 1)
    assert toptim.learning_rate_at(port, 2) < toptim.learning_rate_at(port, 1)


def test_a_missing_gradient_counts_as_zero_and_state_is_float32():
    a = torch.nn.Parameter(torch.ones(4))
    b = torch.nn.Parameter(torch.ones(2))
    opt = toptim.make_optimizer(port_config(_config()), [a, b])
    a.grad = torch.full((4,), 0.5)
    norm = opt.step()
    assert norm.item() == pytest.approx(1.0)
    assert opt.count == 1
    assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)
    assert (opt.mu[1] == 0).all() and (a.detach() < 1).all()
    opt.zero_grad()
    assert a.grad is None
