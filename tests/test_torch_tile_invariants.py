"""What the flow kernels' tensor-core body and live-tile schedule rely on,
held on the CPU at small size.

* Exact zeros past each sample's last valid frame: the flow kernels compute
  no tile whose first owned frame lies there and write zeros instead, which
  is exact only if every version of each function gives exact zeros there.
  Held for the port's plain versions (``flow_step_reference`` both ways,
  ``coupling_reference``, ``flow_stack_reference``,
  ``flow_stack_train_reference`` with dropout) and for the JAX package's
  Pallas kernels in interpret mode, on ragged masks and a mask with holes.
* The weights' split into TF32 halves where they are packed
  (``tensor_core_layout``): ``hi`` is ``tf32_round(w)`` and ``hi + lo == w``
  exactly, in the mma fragment order, and the gate-column interleave and
  the layout undo exactly, so a pack leaves the plain result equal.
* The live-tile schedule's mirror (``live_tile_schedule``): every (sample,
  tile) once, the live ones (first owned frame below the sample's length)
  first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops.coupling import (fused_coupling, fused_flow_stack,
                                       fused_flow_step)
from glow_tts_tpu.ops.coupling_grad import fused_flow_stack_train
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.ops import coupling_grad as tg
from tests.torch_port_helpers import t

C, N, K, CH = 16, 2, 5, 16
STEPS = 2
# (T, lengths, holes): frames [a, b) of sample i set to 0 inside its length
MASKS = [
    (9, [9, 6, 1], {}),
    (13, [5, 13, 12], {0: (1, 3), 2: (4, 9)}),
]


def from_tensor_core_layout(w_tc):
    """Inverse of ``tensor_core_layout``: ``hi + lo`` as ``[..., K, N]``."""
    *lead, kb, nb, _, _ = w_tc.shape
    d = len(lead)
    pairs = w_tc.reshape(*lead, kb, nb, 8, 4, 4)
    w = pairs[..., :2] + pairs[..., 2:]                   # [kb, nb, g, t, h]
    w = w.permute(*range(d), d, d + 4, d + 3, d + 1, d + 2)
    return w.reshape(*lead, 8 * kb, 8 * nb)


def deinterleave_gate(w, k):
    """Inverse of ``interleave_gate``: ``[..., k·ch, 2ch]`` → ``[..., k,
    ch, 2ch]`` with the tanh columns first."""
    *lead, kch, ch2 = w.shape
    w = w.reshape(*lead, kch, ch2 // 2, 2).transpose(-1, -2)
    return w.reshape(*lead, k, kch // k, ch2)


def _mask(case):
    frames, lengths, holes = MASKS[case]
    mask = (np.arange(frames)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.float32)
    for i, (a, b) in holes.items():
        mask[i, a:b] = 0.0
    return mask[..., None], np.asarray(lengths)


def _weights(rng, steps=None, train=False):
    lead = () if steps is None else (steps,)

    def rnd(*shape, scale):
        return (rng.standard_normal(lead + shape) * scale).astype(np.float32)

    w = {'w_start': rnd(C // 2, CH, scale=.3), 'b_start': rnd(CH, scale=.1),
         'w_in': rnd(N, K, CH, 2 * CH, scale=.2),
         'w_rs': rnd(N, CH, 2 * CH, scale=.2),
         'b_rs': rnd(N, 2 * CH, scale=.1),
         'w_end': rnd(CH, C, scale=.2), 'b_end': rnd(C, scale=.1),
         'an_logs': rnd(C, scale=.05), 'an_bias': rnd(C, scale=.1),
         'mix_t': rnd(C, C, scale=.3),
         'ld_const': rnd(scale=.01).reshape(lead)}
    w['w_rs'][..., -1, :, :CH] = 0.0
    w['b_rs'][..., -1, :CH] = 0.0
    if train:
        w['b_in'] = rnd(N, 2 * CH, scale=.1)
    return w


def _past(mask, lengths):
    """[B, T, 1] bool: frames at or past each sample's last valid frame."""
    frames = mask.shape[1]
    return (np.arange(frames)[None, :, None]
            >= np.asarray(lengths)[:, None, None])


def _assert_zero_past(z, mask, lengths, what):
    z = np.asarray(z)
    past = np.broadcast_to(_past(mask, lengths), z.shape)
    assert past.any(), 'the case has frames past a length'
    assert (z[past] == 0).all(), f'{what}: nonzero past the last valid frame'


@pytest.mark.parametrize('case', range(len(MASKS)))
@pytest.mark.parametrize('reverse', [False, True])
def test_flow_step_is_zero_past_the_last_valid_frame(case, reverse):
    rng = np.random.default_rng(10 + case)
    mask, lengths = _mask(case)
    b, frames = mask.shape[:2]
    # an unmasked input: the zeros come from the function itself
    x = (rng.standard_normal((b, frames, C)) * 3).astype(np.float32)
    w = _weights(rng)
    cond = (rng.standard_normal((N, b, 2 * CH)) * .2).astype(np.float32)
    z, _ = tc.flow_step_reference(t(x), t(mask),
                                  {k: t(v) for k, v in w.items()}, t(cond),
                                  reverse)
    _assert_zero_past(z.numpy(), mask, lengths, 'flow_step_reference')
    z_jax, _ = fused_flow_step(jnp.asarray(x), jnp.asarray(mask),
                               {k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(cond), reverse=reverse,
                               interpret=True)
    _assert_zero_past(z_jax, mask, lengths, 'fused_flow_step')


@pytest.mark.parametrize('reverse', [False, True])
def test_coupling_is_zero_past_the_last_valid_frame(reverse):
    rng = np.random.default_rng(20)
    mask, lengths = _mask(1)
    b, frames = mask.shape[:2]
    x = rng.standard_normal((b, frames, C)).astype(np.float32)
    w = {k: v for k, v in _weights(rng).items()
         if k in tc.COUPLING_WEIGHT_KEYS}
    cond = (rng.standard_normal((N, b, 2 * CH)) * .2).astype(np.float32)
    x_a, x_b = x[..., :C // 2], x[..., C // 2:]
    z_b, _ = tc.coupling_reference(t(x_a), t(x_b), t(mask),
                                   {k: t(v) for k, v in w.items()}, t(cond),
                                   reverse=reverse)
    _assert_zero_past(z_b.numpy(), mask, lengths, 'coupling_reference')
    z_jax, _ = fused_coupling(jnp.asarray(x_a), jnp.asarray(x_b),
                              jnp.asarray(mask),
                              {k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(cond), reverse=reverse,
                              interpret=True)
    _assert_zero_past(z_jax, mask, lengths, 'fused_coupling')


@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_is_zero_past_the_last_valid_frame(reverse):
    rng = np.random.default_rng(30)
    mask, lengths = _mask(1)
    b, frames = mask.shape[:2]
    x = rng.standard_normal((b, frames, C)).astype(np.float32)
    w = _weights(rng, STEPS)
    if reverse:
        del w['ld_const']
    cond = (rng.standard_normal((STEPS, N, b, 2 * CH)) * .2).astype(np.float32)
    z, _ = tc.flow_stack_reference(t(x), t(mask),
                                   {k: t(v) for k, v in w.items()}, t(cond),
                                   reverse=reverse)
    _assert_zero_past(z.numpy(), mask, lengths, 'flow_stack_reference')
    z_jax, _ = fused_flow_stack(jnp.asarray(x), jnp.asarray(mask),
                                {k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(cond), reverse=reverse,
                                interpret=True)
    _assert_zero_past(z_jax, mask, lengths, 'fused_flow_stack')


@pytest.mark.parametrize('case', range(len(MASKS)))
def test_train_stack_is_zero_past_the_last_valid_frame(case):
    rng = np.random.default_rng(40 + case)
    mask, lengths = _mask(case)
    b, frames = mask.shape[:2]
    x = rng.standard_normal((b, frames, C)).astype(np.float32)
    w = _weights(rng, STEPS, train=True)
    z, _ = tg.flow_stack_train_reference(
        t(x), t(mask), {k: t(v) for k, v in w.items()}, seed=-5,
        dropout_rate=0.3)
    _assert_zero_past(z.numpy(), mask, lengths, 'flow_stack_train_reference')
    z_jax, _ = fused_flow_stack_train(
        jnp.asarray(x), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in w.items()}, seed=jnp.int32(-5),
        dropout_rate=0.3, interpret=True)
    _assert_zero_past(z_jax, mask, lengths, 'fused_flow_stack_train')


@pytest.mark.parametrize('shape', [(8, 8), (24, 16), (2, 3, 40, 32)])
def test_tensor_core_layout_splits_exactly(shape):
    rng = np.random.default_rng(sum(shape))
    w = t((rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 2, shape))
          .astype(np.float32))
    packed = tc.tensor_core_layout(w)
    *lead, k, n = shape
    assert packed.shape == (*lead, k // 8, n // 8, 32, 4)
    hi = from_tensor_core_layout(
        torch.cat([packed[..., :2], torch.zeros_like(packed[..., 2:])], -1))
    lo = from_tensor_core_layout(
        torch.cat([torch.zeros_like(packed[..., :2]), packed[..., 2:]], -1))
    assert torch.equal(hi, tc.tf32_round(w))
    assert torch.equal(hi + lo, w)
    assert torch.equal(from_tensor_core_layout(packed), w)
    # lane 4g + t of block (kb, nb): w[8kb + t (+ 4), 8nb + g]
    kb, nb, g, tt = k // 8 - 1, n // 8 - 1, 5, 2
    lane = packed[(0,) * len(lead) + (kb, nb, 4 * g + tt)]
    first = (0,) * len(lead)
    assert torch.equal(lane[0] + lane[2], w[first + (8 * kb + tt, 8 * nb + g)])
    assert torch.equal(lane[1] + lane[3],
                       w[first + (8 * kb + tt + 4, 8 * nb + g)])


def test_gate_interleave_puts_both_halves_of_a_channel_side_by_side():
    rng = np.random.default_rng(3)
    w_in = t(rng.standard_normal((STEPS, N, K, CH, 2 * CH)).astype(np.float32))
    mixed = tc.interleave_gate(w_in)
    assert mixed.shape == (STEPS, N, K * CH, 2 * CH)
    flat = w_in.reshape(STEPS, N, K * CH, 2 * CH)
    assert torch.equal(mixed[..., 0::2], flat[..., :CH])
    assert torch.equal(mixed[..., 1::2], flat[..., CH:])
    assert torch.equal(deinterleave_gate(mixed, K), w_in)


@pytest.mark.parametrize('reverse', [False, True])
def test_packed_weights_leave_the_plain_flow_step_equal(reverse):
    """The weights the kernels read, unpacked, give the plain version's
    result bit for bit: the pack reorders and splits, and loses nothing."""
    rng = np.random.default_rng(50)
    mask, _ = _mask(1)
    b, frames = mask.shape[:2]
    x = t(rng.standard_normal((b, frames, C)).astype(np.float32))
    w = {k: t(v) for k, v in _weights(rng).items()}
    cond = t((rng.standard_normal((N, b, 2 * CH)) * .2).astype(np.float32))
    packed = tc.with_tensor_core_weights(w)
    assert tc.with_tensor_core_weights(packed) is packed
    # at ch 16 the float32 body computes at 64 channels, zero-padded
    chp = tc.geometry(tc.FlowShape(C, CH, N, K))['ch_pad']
    w_in = deinterleave_gate(from_tensor_core_layout(packed['w_in_tc']), K)
    w_rs = from_tensor_core_layout(packed['w_rs_tc'])
    assert torch.equal(w_in, tc.padded_wavenet('w_in', w['w_in'], chp))
    assert torch.equal(w_rs, tc.padded_wavenet('w_rs', w['w_rs'], chp))
    unpacked = dict(w, w_in=torch.cat([w_in[..., :CH, :CH],
                                       w_in[..., :CH, chp:chp + CH]], -1),
                    w_rs=torch.cat([w_rs[..., :CH, :CH],
                                    w_rs[..., :CH, chp:chp + CH]], -1))
    assert torch.equal(unpacked['w_in'], w['w_in'])
    assert torch.equal(unpacked['w_rs'], w['w_rs'])
    z, ld = tc.flow_step_reference(x, t(mask), w, cond, reverse)
    z2, ld2 = tc.flow_step_reference(x, t(mask), unpacked, cond, reverse)
    assert torch.equal(z, z2)
    assert (ld is None and ld2 is None) or torch.equal(ld, ld2)
    # and the padded weights the body reads give the same step
    padded = {**w, **{key: tc.padded_wavenet(key, w[key], chp)
                      for key in w}}
    z3, ld3 = tc.flow_step_reference(
        x, t(mask), padded, tc.kernel_cond(cond, chp), reverse)
    torch.testing.assert_close(z3, z, rtol=1e-6, atol=1e-6)
    if ld is not None:
        torch.testing.assert_close(ld3, ld, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('tile', [tc.TIME_TILE, tc.RING_TIME_TILE])
@pytest.mark.parametrize('lengths,frames', [
    ([1, 32, 33, 512], 512), ([0, 5, 64], 70), ([100] * 3, 100), ([7], 7),
    ([47, 48, 49, 333], 333)])
def test_live_tile_schedule_covers_the_tiles_below_each_length(lengths,
                                                               frames, tile):
    """At the float32 builds' tile and at the bfloat16 flow step's."""
    items = tc.live_tile_schedule(lengths, frames, tile)
    n_tiles = -(-frames // tile)
    assert sorted((b, i) for b, i, _ in items) == [
        (b, i) for b in range(len(lengths)) for i in range(n_tiles)]
    for b, i, live in items:
        assert live == (i * tile < lengths[b])
    live = [item for item in items if item[2]]
    assert items[:len(live)] == live                  # the live ones first
    assert len(live) == sum(-(-n // tile) for n in lengths)


def test_live_tiles_follow_the_last_valid_frame_of_a_mask_with_holes():
    mask, lengths = _mask(1)
    got = tc.valid_lengths(t(mask))
    assert got.tolist() == lengths.tolist()
    assert tg._valid_lengths(t(mask)).tolist() == lengths.tolist()
    items = tc.live_tile_schedule(got.tolist(), mask.shape[1], 4)
    assert [i for b, i, live in items if live and b == 0] == [0, 1]
