"""The port's coupling and flow-stack functions (``coupling_reference`` and
``flow_stack_reference``, the plain versions of the CUDA kernels, through
their wrappers on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, ``fused_coupling`` and ``fused_flow_stack``, on the same
weight dicts made from a numpy seed: forward and reverse, ragged lengths,
with and without pitch conditioning, 1 to 4 flow steps.  Tolerances are
those of ``tests/test_torch_decoder.py``: rtol 3e-5, atol 3e-6 on z; rtol
3e-5, atol 1e-4 on the logdet (a sum over frames, channels and steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops.coupling import fused_coupling, fused_flow_stack
from glow_tts_tpu_torch.ops import coupling as tc
from tests.torch_port_helpers import ragged, t

Z_TOL = dict(rtol=3e-5, atol=3e-6)
LD_TOL = dict(rtol=3e-5, atol=1e-4)
C, N, K, CH = 16, 2, 5, 16

CASES = [  # (T, lengths)
    (9, [9, 6, 3]),
    (7, [1, 7]),
    (13, [13, 1, 5, 12]),
]


def _weights(rng, steps, pitch_size=0):
    """One flow step's weight dict per step, stacked along a leading axis;
    a nonzero end conv and an orthogonal mixing matrix."""
    def rnd(*shape, scale):
        return rng.standard_normal((steps, *shape)) * scale

    w = {
        'w_start': rnd(C // 2, CH, scale=.3), 'b_start': rnd(CH, scale=.1),
        'w_in': rnd(N, K, CH, 2 * CH, scale=.2),
        'w_rs': rnd(N, CH, 2 * CH, scale=.2),
        'b_rs': rnd(N, 2 * CH, scale=.1),
        'w_end': rnd(CH, C, scale=.2), 'b_end': rnd(C, scale=.1),
        'an_logs': rnd(C, scale=.05), 'an_bias': rnd(C, scale=.1),
        'mix_t': np.stack([np.linalg.qr(rng.standard_normal((C, C)))[0]
                           for _ in range(steps)]),
        'ld_const': rng.standard_normal(steps) * .01,
    }
    w['w_rs'][:, -1, :, :CH] = 0.0        # the last layer has no res half
    w['b_rs'][:, -1, :CH] = 0.0
    if pitch_size:
        w['w_pitch'] = rnd(N, pitch_size, 2 * CH, scale=.2)
    return {key: np.asarray(v, np.float32) for key, v in w.items()}


def _step(weights, s, keys=None):
    return {key: v[s] for key, v in weights.items()
            if keys is None or key in keys}


def _jnp(tree):
    return {key: jnp.asarray(v) for key, v in tree.items()}


def _torch(tree):
    return {key: t(v) for key, v in tree.items()}


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('pitch_size', [0, 2])
@pytest.mark.parametrize('case', range(len(CASES)))
def test_coupling_matches_pallas_coupling(case, pitch_size, reverse):
    length, lengths = CASES[case]
    b = len(lengths)
    rng = np.random.default_rng(50 + case)
    x, mask = ragged(rng, b, length, C, lengths)
    x_a, x_b = x[..., :C // 2], x[..., C // 2:]
    keys = tc.COUPLING_WEIGHT_KEYS + ('w_pitch',)
    w = _step(_weights(rng, 1, pitch_size), 0, keys)
    cond = (rng.standard_normal((N, b, 2 * CH)) * .2).astype(np.float32)
    pitch = ((rng.standard_normal((b, length, pitch_size)) * mask)
             .astype(np.float32) if pitch_size else None)

    z_ref, ld_ref = fused_coupling(
        jnp.asarray(x_a), jnp.asarray(x_b), jnp.asarray(mask), _jnp(w),
        jnp.asarray(cond), None if pitch is None else jnp.asarray(pitch),
        reverse=reverse, interpret=True)
    # the halves as the decoder hands them over: views of one tensor
    xt = t(x)
    z_b, ld = tc.coupling(xt[..., :C // 2], xt[..., C // 2:], t(mask),
                          _torch(w), t(cond),
                          None if pitch is None else t(pitch), reverse)
    assert z_b.shape == (b, length, C // 2)
    np.testing.assert_allclose(z_b.numpy(), np.asarray(z_ref), **Z_TOL)
    if reverse:
        assert ld is None and ld_ref is None
    else:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('steps', [1, 2, 3, 4])
@pytest.mark.parametrize('case', range(len(CASES)))
def test_flow_stack_matches_pallas_flow_stack(case, steps, reverse):
    length, lengths = CASES[case]
    b = len(lengths)
    rng = np.random.default_rng(60 + 10 * case + steps)
    x, mask = ragged(rng, b, length, C, lengths)
    w = _weights(rng, steps)
    if reverse:
        del w['ld_const']
    cond = (rng.standard_normal((steps, N, b, 2 * CH)) * .2
            ).astype(np.float32)
    z_ref, ld_ref = fused_flow_stack(
        jnp.asarray(x), jnp.asarray(mask), _jnp(w), jnp.asarray(cond),
        reverse=reverse, interpret=True)
    z, ld = tc.flow_stack(t(x), t(mask), _torch(w), t(cond), reverse=reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if reverse:
        assert ld is None and ld_ref is None
    else:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_with_pitch_matches_pallas(reverse):
    rng = np.random.default_rng(70)
    steps, b, length, ps = 3, 3, 11, 2
    x, mask = ragged(rng, b, length, C, [11, 7, 4])
    w = _weights(rng, steps, pitch_size=ps)
    cond = (rng.standard_normal((steps, N, b, 2 * CH)) * .2
            ).astype(np.float32)
    pitch = (rng.standard_normal((b, length, ps)) * mask).astype(np.float32)
    z_ref, ld_ref = fused_flow_stack(
        jnp.asarray(x), jnp.asarray(mask), _jnp(w), jnp.asarray(cond),
        jnp.asarray(pitch), reverse=reverse, interpret=True)
    z, ld = tc.flow_stack(t(x), t(mask), _torch(w), t(cond), t(pitch),
                          reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if not reverse:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_is_the_chain_of_flow_steps(reverse):
    """Steps 0 … S − 1 forward, S − 1 … 0 on the inverse pass, each a
    ``flow_step_reference``; the logdets added over the steps."""
    rng = np.random.default_rng(71)
    steps, b, length = 3, 2, 10
    x, mask = ragged(rng, b, length, C, [10, 4])
    w = _torch(_weights(rng, steps))
    cond = t((rng.standard_normal((steps, N, b, 2 * CH)) * .2
              ).astype(np.float32))
    z, ld = tc.flow_stack_reference(t(x), t(mask), w, cond, reverse=reverse)
    chained, total = t(x), torch.zeros(b)
    for s in (reversed(range(steps)) if reverse else range(steps)):
        chained, step_ld = tc.flow_step_reference(
            chained, t(mask), _step(w, s), cond[s], reverse)
        if not reverse:
            total = total + step_ld
    torch.testing.assert_close(z, chained, rtol=0, atol=0)
    if reverse:
        assert ld is None
    else:
        torch.testing.assert_close(ld, total, rtol=0, atol=0)


def test_flow_stack_round_trip():
    """The inverse pass over the same steps with each mixing matrix
    inverted (an orthogonal matrix's transpose) undoes the forward pass."""
    rng = np.random.default_rng(72)
    steps, b, length = 4, 3, 12
    x, mask = ragged(rng, b, length, C, [12, 5, 1])
    w = _torch(_weights(rng, steps))
    cond = t((rng.standard_normal((steps, N, b, 2 * CH)) * .2
              ).astype(np.float32))
    z, _ = tc.flow_stack(t(x), t(mask), w, cond)
    inverse = dict(w, mix_t=w['mix_t'].transpose(1, 2).contiguous())
    back, _ = tc.flow_stack(z, t(mask), inverse, cond, reverse=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-5)


def test_wrappers_on_cpu_are_the_plain_versions():
    """A CPU tensor goes to the plain version, and no kernel launch is
    counted."""
    rng = np.random.default_rng(73)
    steps, b, length = 2, 2, 6
    x, mask = ragged(rng, b, length, C, [6, 2])
    w = _torch(_weights(rng, steps))
    cond = t((rng.standard_normal((steps, N, b, 2 * CH)) * .2
              ).astype(np.float32))
    xt, mt = t(x), t(mask)
    before = (tc.coupling.launches, tc.flow_stack.launches)
    for reverse in (False, True):
        z, ld = tc.flow_stack(xt, mt, w, cond, reverse=reverse)
        z_ref, ld_ref = tc.flow_stack_reference(xt, mt, w, cond,
                                                reverse=reverse)
        torch.testing.assert_close(z, z_ref, rtol=0, atol=0)
        w0 = _step(w, 0, tc.COUPLING_WEIGHT_KEYS)
        halves = xt[..., :C // 2], xt[..., C // 2:]
        z_b, ld = tc.coupling(*halves, mt, w0, cond[0], reverse=reverse)
        z_b_ref, ld_ref = tc.coupling_reference(*halves, mt, w0, cond[0],
                                                reverse=reverse)
        torch.testing.assert_close(z_b, z_b_ref, rtol=0, atol=0)
        assert (ld is None) == reverse
    assert (tc.coupling.launches, tc.flow_stack.launches) == before


def test_coupling_is_the_flow_steps_coupling():
    """``coupling_reference`` on the mixing's output is the coupling that
    ``flow_step_reference`` applies: ActNorm and mixing by hand, then the
    coupling, equal the whole step."""
    rng = np.random.default_rng(74)
    b, length = 3, 9
    x, mask = ragged(rng, b, length, C, [9, 6, 3])
    w = _step(_torch(_weights(rng, 1)), 0)
    cond = t((rng.standard_normal((N, b, 2 * CH)) * .2).astype(np.float32))
    xt, mt = t(x), t(mask)
    z_step, ld_step = tc.flow_step_reference(xt, mt, w, cond)
    y = ((w['an_bias'] + torch.exp(w['an_logs']) * xt) * mt @ w['mix_t']) * mt
    z_b, ld = tc.coupling_reference(y[..., :C // 2], y[..., C // 2:], mt, w,
                                    cond)
    torch.testing.assert_close(torch.cat([y[..., :C // 2], z_b], dim=-1),
                               z_step, rtol=0, atol=0)
    torch.testing.assert_close(ld + w['ld_const'] * mt.sum(dim=(1, 2)),
                               ld_step, rtol=1e-6, atol=1e-5)
