"""The port's plain MAS (``maximum_path_reference``, what a CPU tensor
takes and what the CUDA kernels are held against on the card) against the
JAX package's three formulations on the same inputs: the ``lax.scan``
twin, the numpy banded-DP oracle, and the Pallas kernel in TPU interpret
mode.  So are its two parts, the twins of the two kernels: the token of
each frame (``maximum_path_index_reference``) and its expansion into the
path (``expand_path_reference``), and the twin of the first kernel's walk
over packed direction words (``walk_windows_reference``).  The bar is
equality of every element; no tolerance.

The numpy oracle walks cells outside the band when a sample has more
tokens than frames, where the scan formulation (and with it the Pallas
kernel and the port) is defined by its own arithmetic; those cases are
held against scan and Pallas only."""

import functools

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
    # the edges of a 32-token word of direction bits
    'word_edge_31': (dict(seed=20, b=3, t_tok=31, t_mel=70), True),
    'word_edge_32': (dict(seed=21, b=3, t_tok=32, t_mel=64), True),
    'word_edge_33': (dict(seed=22, b=3, t_tok=33, t_mel=97), True),
    'word_edge_65': (dict(seed=23, b=2, t_tok=65, t_mel=130), True),
    # as many tokens as frames: the path drops a token on every frame, over
    # whole 32-frame windows of the walk
    'drops_every_frame': (dict(seed=24, b=2, t_tok=70, t_mel=70,
                               lengths=([70, 40], [70, 40])), True),
    'token_length_1': (dict(seed=25, b=3, t_tok=9, t_mel=40,
                            lengths=([1, 1, 9], [40, 1, 33])), True),
    'more_tokens_than_frames_wide': (dict(seed=26, b=2, t_tok=50, t_mel=33,
                                          lengths=([50, 45], [33, 20])),
                                     False),
    # the walk crosses many 32-frame windows
    'long_walk': (dict(seed=27, b=2, t_tok=40, t_mel=1500), True),
}


def _resolved(case, oracle):
    """The problem and oracle of (case, oracle): where the numpy oracle is
    not defined, still a real check, against scan on a second draw."""
    kwargs, numpy_defined = CASES[case]
    if oracle == 'numpy' and not numpy_defined:
        return dict(kwargs, seed=kwargs['seed'] + 100), 'scan'
    return kwargs, oracle


@functools.lru_cache(maxsize=None)
def _oracle_run(case, oracle):
    """(log_p, token lengths, mel lengths, the oracle's path), computed once
    per (case, oracle) for the tests below."""
    kwargs, oracle = _resolved(case, oracle)
    log_p, tl, ml = _problem(**kwargs)
    return log_p, tl, ml, ORACLES[oracle](log_p, tl, ml)


def _index_of(path):
    """The token of each frame of a path [B, T_tok, T_mel] in {0, 1}, -1
    where the frame has none."""
    return np.where(path.any(axis=1), path.argmax(axis=1), -1).astype(np.int32)


@pytest.mark.parametrize('oracle', sorted(ORACLES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_reference_equals_jax(case, oracle):
    log_p, tl, ml, expected = _oracle_run(case, oracle)
    got = _port(log_p, tl, ml)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize('oracle', sorted(ORACLES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_index_equals_jax(case, oracle):
    """The first kernel's twin: the token of each frame, -1 past each
    sample's frames."""
    log_p, tl, ml, expected = _oracle_run(case, oracle)
    got = tmas.maximum_path_index_reference(
        torch.from_numpy(log_p), torch.from_numpy(tl), torch.from_numpy(ml))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _index_of(expected))


@pytest.mark.parametrize('oracle', sorted(ORACLES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_expanding_the_jax_index_gives_the_jax_path(case, oracle):
    """The second kernel's twin, on the index the JAX path holds."""
    log_p, _, _, expected = _oracle_run(case, oracle)
    got = tmas.expand_path_reference(
        torch.from_numpy(_index_of(expected)), log_p.shape[1])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('oracle', sorted(ORACLES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_windowed_walk_equals_jax(case, oracle):
    """The kernel's walk over packed direction words, 32 frames a window,
    gives the JAX path's tokens."""
    log_p, tl, ml, expected = _oracle_run(case, oracle)
    words = tmas.pack_directions(tmas.mas_directions(torch.from_numpy(log_p)))
    got = tmas.walk_windows_reference(words, torch.from_numpy(tl),
                                      torch.from_numpy(ml), log_p.shape[2])
    np.testing.assert_array_equal(got.numpy(), _index_of(expected))


@pytest.mark.parametrize('case', sorted(CASES))
def test_windowed_walk_equals_the_plain_walk(case):
    log_p, tl, ml = _problem(**CASES[case][0])
    tl, ml = torch.from_numpy(tl), torch.from_numpy(ml)
    directions = tmas.mas_directions(torch.from_numpy(log_p))
    assert torch.equal(
        tmas.walk_windows_reference(tmas.pack_directions(directions), tl, ml,
                                    log_p.shape[2]),
        tmas.walk_reference(directions, tl, ml))


def test_packed_directions_hold_32_frames_a_word_per_token():
    rng = np.random.default_rng(11)
    directions = torch.from_numpy(rng.random((2, 5, 70)) < 0.5)
    words = tmas.pack_directions(directions)
    assert words.shape == (2, 3, 5)                # ceil(70 / 32) words
    for b, c, t, f in [(0, 0, 0, 0), (1, 2, 4, 5), (0, 1, 3, 31),
                       (1, 0, 2, 17)]:
        bit = int(directions[b, t, 32 * c + f])
        assert (int(words[b, c, t]) >> f) & 1 == bit
    assert (words[:, 2] >> 6).eq(0).all()          # nothing past frame 69


def test_lengths_out_of_range_give_no_path_as_scan_does():
    """A sample with no token, or more tokens than log_p has, is aligned to
    nothing (the index -1 everywhere), as ``maximum_path_scan`` has it."""
    log_p, tl, ml = _problem(seed=28, b=3, t_tok=6, t_mel=12,
                             lengths=([0, 7, 6], [12, 12, 0]))
    index = tmas.maximum_path_index_reference(
        torch.from_numpy(log_p), torch.from_numpy(tl), torch.from_numpy(ml))
    assert (index == -1).all()
    np.testing.assert_array_equal(_port(log_p, tl, ml), _scan(log_p, tl, ml))


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


def _stays_on_token_0():
    """Scores that keep the path on token 0 for all but the last two frames
    while token 0's value sinks below the illegal score (-1e9): its
    direction bit is then set, and only the walk's guard keeps the token
    at 0."""
    log_p = np.zeros((1, 3, 12), np.float32)
    log_p[0, 0] = -2e8
    log_p[0, 1:] = -5e8
    return log_p, np.array([3], np.int32), np.array([12], np.int32)


@pytest.mark.parametrize('oracle', sorted(ORACLES))
def test_token_0_never_steps_down(oracle):
    log_p, tl, ml = _stays_on_token_0()
    expected = ORACLES[oracle](log_p, tl, ml)
    np.testing.assert_array_equal(_index_of(expected)[0],
                                  [0] * 10 + [1, 2])
    directions = tmas.mas_directions(torch.from_numpy(log_p))
    assert directions[0, 0, 9]                     # token 0's bit is set
    np.testing.assert_array_equal(_port(log_p, tl, ml), expected)
    tl, ml = torch.from_numpy(tl), torch.from_numpy(ml)
    np.testing.assert_array_equal(
        tmas.walk_windows_reference(tmas.pack_directions(directions), tl, ml,
                                    12).numpy(), _index_of(expected))
