"""The port's plain MAS (``maximum_path_reference``, what a CPU tensor
takes and what the CUDA kernel is held against on the card) against the
JAX package's three formulations on the same inputs: the ``lax.scan``
twin, the numpy banded-DP oracle, and the Pallas kernel in TPU interpret
mode.  The bar is equality of every element; no tolerance.

The numpy oracle walks cells outside the band when a sample has more
tokens than frames, where the scan formulation (and with it the Pallas
kernel and the port) is defined by its own arithmetic; those cases are
held against scan and Pallas only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from glow_tts_tpu.ops import mas as jmas
from glow_tts_tpu_torch.ops import mas as tmas


def _problem(seed, b, t_tok, t_mel, lengths=None, mask=True):
    rng = np.random.default_rng(seed)
    log_p = rng.standard_normal((b, t_tok, t_mel)).astype(np.float32)
    if lengths is None:
        tl = rng.integers(1, t_tok + 1, size=b)
        ml = np.array([rng.integers(x, t_mel + 1) for x in tl])
    else:
        tl, ml = (np.asarray(x) for x in lengths)
    tl, ml = tl.astype(np.int32), ml.astype(np.int32)
    if mask:        # as the model does: log_p is zero outside the lengths
        log_p = (log_p * (np.arange(t_tok)[None, :, None] < tl[:, None, None])
                 * (np.arange(t_mel)[None, None, :] < ml[:, None, None]))
    return log_p.astype(np.float32), tl, ml


def _port(log_p, tl, ml):
    return tmas.maximum_path_reference(
        torch.from_numpy(log_p), torch.from_numpy(tl),
        torch.from_numpy(ml)).numpy()


def _scan(log_p, tl, ml):
    return np.asarray(jmas.maximum_path_scan(
        jnp.asarray(log_p), jnp.asarray(tl), jnp.asarray(ml)))


def _numpy(log_p, tl, ml):
    return jmas.maximum_path_numpy(log_p, tl, ml).astype(np.float32)


def _pallas(log_p, tl, ml):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jmas.maximum_path_pallas(
            jnp.asarray(log_p), jnp.asarray(tl), jnp.asarray(ml)))


ORACLES = {'scan': _scan, 'numpy': _numpy, 'pallas_interpret': _pallas}

# name → (problem arguments, whether the numpy oracle is defined on it)
CASES = {
    'ragged_seed0': (dict(seed=0, b=5, t_tok=37, t_mel=93), True),
    'ragged_seed1': (dict(seed=1, b=5, t_tok=37, t_mel=93), True),
    'ragged_seed2_odd_frames': (dict(seed=2, b=3, t_tok=33, t_mel=65), True),
    'ragged_unmasked': (dict(seed=3, b=4, t_tok=20, t_mel=50, mask=False),
                        True),
    # forced diagonal, a single token, a single frame, padding-like samples
    'degenerate': (dict(seed=7, b=4, t_tok=8, t_mel=16,
                        lengths=([8, 1, 1, 3], [8, 5, 1, 16])), True),
    'more_tokens_than_frames': (dict(seed=9, b=3, t_tok=12, t_mel=10,
                                     lengths=([12, 7, 2], [5, 3, 1])), False),
}


@pytest.mark.parametrize('oracle', sorted(ORACLES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_reference_equals_jax(case, oracle):
    kwargs, numpy_defined = CASES[case]
    if oracle == 'numpy' and not numpy_defined:
        # still a real check: the port against scan, on a second draw
        kwargs, oracle = dict(kwargs, seed=kwargs['seed'] + 100), 'scan'
    log_p, tl, ml = _problem(**kwargs)
    got = _port(log_p, tl, ml)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ORACLES[oracle](log_p, tl, ml))


def test_paths_are_monotone_and_cover_each_valid_frame_once():
    log_p, tl, ml = _problem(seed=4, b=6, t_tok=24, t_mel=60)
    path = _port(log_p, tl, ml)
    for p, tx, ty in zip(path, tl, ml):
        assert (p[:, :ty].sum(axis=0) == 1).all()
        assert (p[:, ty:] == 0).all() and (p[tx:] == 0).all()
        idx = p[:, :ty].argmax(axis=0)
        assert idx[0] == 0 and idx[-1] == tx - 1
        assert set(np.diff(idx)) <= {0, 1}


def test_wrapper_takes_the_plain_version_on_cpu_only():
    log_p, tl, ml = (torch.from_numpy(a) for a in
                     _problem(seed=5, b=2, t_tok=6, t_mel=9))
    before = tmas.maximum_path.launches
    got = tmas.maximum_path(log_p, tl, ml)
    assert tmas.maximum_path.launches == before    # no kernel on the CPU
    assert torch.equal(got, tmas.maximum_path_reference(log_p, tl, ml))
    with pytest.raises(ValueError):
        tmas.maximum_path(log_p.to('meta'), tl, ml)
