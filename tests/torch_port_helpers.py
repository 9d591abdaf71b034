"""Shared set-up of the PyTorch port's parity tests: one JAX model at
``tiny_config`` size with perturbed parameters (a nonzero end conv, so no
coupling is the identity), and the port loaded from the same numbers."""

import dataclasses
import os

import jax
import numpy as np
import torch

# Under xdist each worker gets its share of the cores: with torch's default
# of one thread per core in every worker, the workers' thread pools fight
# over the same cores and a step runs many times slower.  A single-process
# run keeps torch's default.
_WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '0') or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

from glow_tts_tpu.training.step import create_train_state
from glow_tts_tpu_torch.config import load_config as port_load_config
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.weights import load_jax_params
from tests.helpers import synthetic_batch, tiny_config


def with_backend(cfg, backend):
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, coupling_backend=backend))


def port_config(jax_cfg):
    """The port's config read from the JAX config's own field tree."""
    return port_load_config(dataclasses.asdict(jax_cfg))


# the conditioned modes the tests run: the config's Mode, and GE2E in
# place of the look-up table for the speaker vector
MODES = ('SE-LUT', 'SE-GE2E', 'PE', 'GR')


def mode_config(mode='Vanilla'):
    """``tiny_config`` in one of ``'Vanilla'`` and :data:`MODES`."""
    if mode != 'SE-GE2E':
        return tiny_config(mode.split('-')[0])
    speaker = tiny_config('SE').speaker_embedding
    return tiny_config('SE', Speaker_Embedding={
        'Type': 'GE2E', 'Num_Speakers': speaker.num_speakers,
        'Embedding_Size': speaker.embedding_size,
        'GE2E': dataclasses.asdict(speaker.ge2e)})


def jax_model(seed=0, perturb=0.03, mode='Vanilla'):
    """(cfg, flax model, numpy params, batch) at tiny size, in ``mode``
    (:func:`mode_config`)."""
    cfg = mode_config(mode)
    batch = synthetic_batch(cfg, batch=4)
    model, state = create_train_state(cfg, jax.random.PRNGKey(seed), batch)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p, np.float32)
                   + perturb * rng.standard_normal(p.shape).astype(
                       np.float32)),
        state.params)
    return cfg, model, params, batch


def port_model(jax_cfg, params):
    cfg = port_config(jax_cfg)
    return load_jax_params(PortGlowTTS(cfg), params, cfg).prepare()


def ragged(rng, b, t, c, lengths):
    """x [B, T, C] masked to ``lengths``, and the mask [B, T, 1]."""
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = (np.arange(t)[None, :, None]
            < np.asarray(lengths)[:, None, None]).astype(np.float32)
    return x * mask, mask


def t(array):
    return torch.from_numpy(np.array(array))


def with_dropout(cfg, rate):
    """``cfg`` (the JAX config) with every dropout rate at ``rate``."""
    enc, dec = cfg.encoder, cfg.decoder
    rep = dataclasses.replace
    enc = rep(enc, prenet=rep(enc.prenet, dropout_rate=rate),
              transformer=rep(enc.transformer, dropout_rate=rate),
              duration_predictor=rep(enc.duration_predictor,
                                     dropout_rate=rate))
    coupling = rep(dec.affine_coupling, wavenet=rep(
        dec.affine_coupling.wavenet, dropout_rate=rate))
    return rep(cfg, encoder=enc, decoder=rep(dec, affine_coupling=coupling))


def at_dtype(cfg, dtype):
    """``cfg`` (the JAX config) computing at ``dtype``
    (``TPU.compute_dtype``)."""
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype=dtype))


# The bf16 tolerance of the port's tests, stated once: the port at bf16 is
# no further from the JAX package at bf16 than the JAX package at bf16 is
# from its own f32 result, all three from the same f32 parameters and
# inputs:  max|port_bf16 − jax_bf16| ≤ 2·max|jax_bf16 − jax_f32| + 1e-6.
# Gradients leaf by leaf: norm-relative error against jax_f32 under 3e-2
# (the JAX package's own bf16 bar, tests/test_coupling_train.py), and
# against jax_bf16 at most twice jax_bf16's against jax_f32, plus 1e-4.
BF16_FACTOR, BF16_ATOL = 2.0, 1e-6
GRAD_F32_BAR, GRAD_FACTOR, GRAD_ATOL = 3e-2, 2.0, 1e-4


def _f64(value):
    if isinstance(value, torch.Tensor):
        value = value.detach().float().numpy()
    return np.asarray(value, np.float64)


def bf16_error(port, j16, j32):
    """``(max|port − jax_bf16|, the bar 2·max|jax_bf16 − jax_f32| +
    1e-6)``."""
    port, j16, j32 = _f64(port), _f64(j16), _f64(j32)
    assert port.shape == j16.shape == j32.shape, (port.shape, j16.shape)
    return (float(np.abs(port - j16).max()),
            BF16_FACTOR * float(np.abs(j16 - j32).max()) + BF16_ATOL)


def assert_bf16_close(port, j16, j32, name=''):
    """The bf16 tolerance above, on one result."""
    err, bar = bf16_error(port, j16, j32)
    assert err <= bar, f'{name}: max|port - jax_bf16| {err:.3e} > {bar:.3e}'
    return err, bar


def norm_rel(a, b):
    """‖a − b‖ / ‖b‖."""
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_bf16_grads(port, j16, j32, zero_floor=1e-5, beyond_own=False):
    """The gradient half of the bf16 tolerance, leaf by leaf over dicts of
    the same keys.  A leaf whose f32 gradient is zero up to f32 rounding
    (below ``zero_floor`` of the largest leaf's norm: the attention's key
    bias, to which the softmax is blind) has no relative error to speak
    of; there both bf16 results are rounding noise of the same size, held
    to ‖port − jax_f32‖ ≤ 2·‖jax_bf16 − jax_f32‖ + 1e-4 · that
    floor.
    With ``beyond_own`` the bar against jax_f32 is 3e-2 beyond jax_bf16's
    own distance from it: for the whole model's gradients at tiny size,
    where the JAX package's bf16 step is itself up to 0.3 from its f32 one
    on the encoder's leaves (the prior's gradient at bf16), and 3e-2 is its
    bar for the flow stack.  Returns the largest norm-relative error
    against jax_f32 among the other leaves."""
    assert set(port) == set(j16) == set(j32)
    floor = zero_floor * max(np.linalg.norm(_f64(v)) for v in j32.values())
    worst = 0.0
    for key in j32:
        ref = _f64(j32[key])
        if np.linalg.norm(ref) < floor:
            got = np.linalg.norm(_f64(port[key]) - ref)
            own = np.linalg.norm(_f64(j16[key]) - ref)
            assert got <= GRAD_FACTOR * own + GRAD_ATOL * floor, (key, got,
                                                                  own)
            continue
        to_f32 = norm_rel(port[key], ref)
        to_bf16 = norm_rel(port[key], j16[key])
        own = norm_rel(j16[key], ref)
        bar = GRAD_F32_BAR + (own if beyond_own else 0.0)
        assert to_f32 < bar, f'{key}: norm-rel to f32 {to_f32:.3e} > {bar:.3e}'
        assert to_bf16 <= GRAD_FACTOR * own + GRAD_ATOL, (
            f'{key}: norm-rel to jax bf16 {to_bf16:.3e}, jax bf16 to f32 '
            f'{own:.3e}')
        worst = max(worst, to_f32)
    return worst
