"""The train kernels (#5 ``flow_train_fwd.cu``, #6 ``flow_train_bwd.cu``)
at decoder shapes besides the shipped 160/80 x 192·4·k5 (ROADMAP B.2, the
train half), on the CPU:

* the train envelope (``ops/coupling.py::train_error``): every B.2 build
  is taken at f32 and bf16, with and without its pitch operand, and the
  shapes a train build cannot take (a saved row the stores do not take,
  too many layers for one reduction launch, outside the deterministic
  envelope) raise naming B.2;
  #5's geometry is the float32 body's with the saving stage, and its pitch
  builds read w_pitch from global memory where the stage has no room;
* the port's ``flow_stack_train_reference`` against the JAX package's at
  C = 200 with the pitch operand and at (C 160, ch 128, 16 layers, k 3),
  dropout 0 and 0.05: z, the logdet and every gradient (weights, x, cond,
  pitch); and the JAX package's Pallas pair in interpret mode at C = 200;
* what the padded forward does, in torch: the WaveNet computed at ch
  padded to the body's width on zero-padded weights, with each padded
  column drawing the dropout bit of its true column
  (``dropmask.padded_stack_mask``), gives the unpadded z, logdet and
  gradients to float64 rounding and zero gradients in every padded row
  and column, over a ``hypothesis`` sweep of ch; the padded width's own
  counters would not;
* the forward's weights at the body's width (``coupling_grad.
  _kernel_weights``: the f32 and bf16 tensor-core layouts, b_in and the
  copies read as they lie, the conditioning rows and w_pitch);
* the backward's launches per flow step at 2 and 16 layers.

Tolerances: ``tests/test_torch_coupling_grad.py``'s (z rtol/atol 2e-5,
logdet rtol 2e-5 / atol 2e-4, gradients rtol/atol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.ops import coupling_grad as tg
from glow_tts_tpu_torch.ops import dropmask
from tests.torch_port_helpers import ragged, t

Z_TOL = dict(rtol=2e-5, atol=2e-5)
LD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEED = -4321
# the B.2 builds (the shape and GR's pitch operand's width, or 0), as
# chip_smoke.py::B2_SHAPES
B2_BUILDS = {'c200': (tc.FlowShape(200), 0),
             'c200_pitch': (tc.FlowShape(200), 2),
             'c16_ch16_l2_k5': (tc.FlowShape(16, 16, 2, 5), 0),
             'c160_ch128_l16_k3': (tc.FlowShape(160, 128, 16, 3), 0)}


# --- the train envelope and geometry -------------------------------------

@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('label', list(B2_BUILDS))
def test_every_b2_build_is_a_train_build(label, bf16):
    shape, ps = B2_BUILDS[label]
    for pitch in {0, ps or 2}:
        assert tc.train_error(shape, bf16, pitch) is None
        w_in = (shape.n_layers, shape.kernel_size, shape.ch, 2 * shape.ch)
        assert tc.check_train_shape('flow_stack_train', shape.channels, w_in,
                                    pitch, bf16) == shape
        g = tc.geometry(shape, bf16, pitch, train=True)
        assert g['block_bytes'] <= tc.BLOCK_BYTES
    assert tc.count_suffix(shape, ps, bf16) == (
        f'{"bf16_" if bf16 else ""}{label}_launches')


@pytest.mark.parametrize('shape,pitch,bf16,why', [
    # a saved row #5 stores and #6 stages 8 bf16 (4 f32) channels at a
    # time, at both dtypes (C = 200 at 8 layers, refused here until #5
    # stored without its saving stage, is taken: the tests of
    # test_torch_b2_rest.py)
    ((200, 12, 8, 5), 0, True, 'ch 12'),
    ((100, 6, 8, 5), 0, False, 'ch 6'),
    ((160, 20, 2, 5), 0, True, 'ch 20'),
    ((160, 10, 2, 5), 0, False, 'ch 10'),
    # more layers than one reduction launch adds (k = 1 has no halo)
    ((8, 4, 30, 1), 0, False, '30 layers'),
    # outside the deterministic envelope, and a pitch width that does not
    # divide C
    ((102, 192, 4, 5), 0, False, 'multiple of 4'),
    ((160, 192, 4, 5), 3, False, 'does not divide')])
def test_shapes_no_train_build_takes_raise_naming_b2(shape, pitch, bf16, why):
    shape = tc.FlowShape(*shape)
    assert why in tc.train_error(shape, bf16, pitch)
    with pytest.raises(ValueError, match='ROADMAP.md B.2, the train half'):
        tc.check_train_shape('flow_stack_train', shape.channels,
                             (shape.n_layers, shape.kernel_size, shape.ch,
                              2 * shape.ch), pitch, bf16)


@pytest.mark.parametrize('shape,pitch', [((256, 192, 4, 5), 2),
                                         ((160, 192, 4, 9), 1),
                                         ((160, 192, 4, 9), 2)])
def test_the_train_block_reads_w_pitch_where_its_stage_has_no_room(shape,
                                                                   pitch):
    """C = 256 and k = 9 at the shipped WaveNet with a pitch operand: the
    saving stage leaves no room for w_pitch's stage (the block would be
    238.7 and 244.2 KB), so the epilogue reads it from global memory and
    the block fits; without the saving stage (the deterministic builds) it
    is staged."""
    shape = tc.FlowShape(*shape)
    train = tc.geometry(shape, False, pitch, train=True)
    assert train['stage_w_pitch'] == 0
    assert train['block_bytes'] <= tc.BLOCK_BYTES
    assert tc.geometry(shape, False, pitch)['stage_w_pitch'] == 1
    assert tc.train_error(shape, False, pitch) is None


def test_the_train_geometry_is_the_float32_body_with_the_saving_stage():
    """#5's block at both dtypes (its bf16 build keeps h and the gate in
    bf16 over the float32 buffers) is the float32 body's with 4·32·(2·ch_pad
    + 4) bytes of saving stage; the shipped builds' pitch instantiations
    stage w_pitch, as they always have."""
    for shape in (*tc.SHIPPED_SHAPES, *(s for s, _ in B2_BUILDS.values())):
        f32 = tc.geometry(shape)
        for bf16 in (False, True):
            g = tc.geometry(shape, bf16, train=True)
            assert g['smem_bytes'] == (f32['smem_bytes']
                                       + 4 * 32 * (2 * f32['ch_pad'] + 4))
            assert (g['time_tile'], g['ch_pad'], g['ring_depth']) == (
                32, f32['ch_pad'], 0)
    for c in tc.BUILT_CHANNELS:
        assert tc.geometry(c, False, tc.SHIPPED_PITCH_SIZE[c],
                           train=True)['stage_w_pitch'] == 1
    assert tc.geometry(160, train=True)['smem_bytes'] == 138048 + 49664
    assert 'flow_train_fwd.cu' in tc.GEOMETRY_SOURCES


def test_backward_launches_per_step_at_two_and_sixteen_layers():
    """6 + 4n kernels a flow step (5n in a pitch build): 14 and 70, 16 and
    86; the reduction's 7 + 5n jobs of a 16-layer pitch build (87) fit
    one launch."""
    assert tg.backward_launches_per_step(2) == 14
    assert tg.backward_launches_per_step(16) == 70
    assert tg.backward_launches_per_step(2, pitch=True) == 16
    assert tg.backward_launches_per_step(16, pitch=True) == 86
    assert 7 + 5 * 16 <= 7 + 5 * tc.TRAIN_MAX_LAYERS
    assert 32 * (7 + 5 * tc.TRAIN_MAX_LAYERS) + 8 <= 4096


# --- the plain versions against the JAX package ---------------------------

def _problem(shape, ps, lengths, seed, steps=2):
    """Stacked float32 weights of ``steps`` flow steps at ``shape`` (scaled
    to their fan-in, the last layer's res half zero), x and the mask of
    ``lengths``, cond [S, n, B, 2ch], the pitch operand (or None) and the
    loss's weights on z and the logdet."""
    c, ch, n, k = shape
    rng = np.random.default_rng(seed)

    def rnd(*dims, scale):
        return (rng.standard_normal((steps, *dims)) * scale).astype(np.float32)
    w = {'w_start': rnd(c // 2, ch, scale=(c / 2) ** -.5),
         'b_start': rnd(ch, scale=.1),
         'w_in': rnd(n, k, ch, 2 * ch, scale=(k * ch) ** -.5),
         'b_in': rnd(n, 2 * ch, scale=.1),
         'w_rs': rnd(n, ch, 2 * ch, scale=ch ** -.5),
         'b_rs': rnd(n, 2 * ch, scale=.1),
         'w_end': rnd(ch, c, scale=.3 * ch ** -.5), 'b_end': rnd(c, scale=.1),
         'an_logs': rnd(c, scale=.05), 'an_bias': rnd(c, scale=.1),
         'mix_t': np.stack([np.linalg.qr(rng.standard_normal((c, c)))[0]
                            for _ in range(steps)]).astype(np.float32),
         'ld_const': rnd(scale=.01)}
    w['w_rs'][:, -1, :, :ch] = 0
    w['b_rs'][:, -1, :ch] = 0
    b, frames = len(lengths), max(lengths)
    x, mask = ragged(rng, b, frames, c, lengths)
    cond = (rng.standard_normal((steps, n, b, 2 * ch)) * .2).astype(np.float32)
    pitch = None
    if ps:
        w['w_pitch'] = rnd(n, ps, 2 * ch, scale=.5)
        pitch = rng.random((b, frames, ps)).astype(np.float32) * mask
    zt = rng.standard_normal((b, frames, c)).astype(np.float32)
    return w, x, mask, cond, pitch, zt


def _jnp(value):
    if isinstance(value, dict):
        return {key: jnp.asarray(v) for key, v in value.items()}
    return None if value is None else jnp.asarray(value)


def _leaf(value):
    return None if value is None else t(value).requires_grad_()


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('label', ['c200_pitch', 'c160_ch128_l16_k3'])
def test_the_plain_train_stack_matches_jax_at_the_b2_shapes(label, rate):
    """z, the logdet and every gradient of a loss through both (a weight
    per sample on the logdet) of the port's plain version against the JAX
    package's twin, with cond (and at C = 200 GR's pitch operand): the
    masks are bit-equal, so dropout adds no tolerance."""
    shape, ps = B2_BUILDS[label]
    w, x, mask, cond, pitch, zt = _problem(shape, ps, [9, 6], 11 + ps)
    ld_weight = np.asarray([1.0, 2.5], np.float32)

    def jax_loss(w_, x_, c_, p_):
        z, ld = JCG.flow_stack_train_reference(
            x_, _jnp(mask), w_, c_, p_, seed=jnp.int32(SEED),
            dropout_rate=rate)
        return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight), (z, ld)

    argnums = (0, 1, 2) + ((3,) if pitch is not None else ())
    grads, (z_ref, ld_ref) = jax.grad(jax_loss, argnums=argnums,
                                      has_aux=True)(
        _jnp(w), _jnp(x), _jnp(cond), _jnp(pitch))

    tw = {key: _leaf(v) for key, v in w.items()}
    tx, tcond, tpitch = _leaf(x), _leaf(cond), _leaf(pitch)
    z, ld = tg.flow_stack_train_reference(tx, t(mask), tw, tcond, tpitch,
                                          seed=SEED, dropout_rate=rate)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref),
                               **Z_TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref),
                               **LD_TOL)
    (torch.sum(z * t(zt)) + 0.7 * torch.sum(ld * t(ld_weight))).backward()
    for key in w:
        np.testing.assert_allclose(tw[key].grad.numpy(),
                                   np.asarray(grads[0][key]), **GRAD_TOL,
                                   err_msg=f'weight grad {key}')
    for name, leaf, ref in (('dx', tx, grads[1]), ('dcond', tcond, grads[2]),
                            ('dpitch', tpitch,
                             grads[3] if pitch is not None else None)):
        if leaf is not None:
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                       **GRAD_TOL, err_msg=name)


def test_the_plain_train_stack_matches_pallas_at_c200():
    """The JAX package's Pallas pair in interpret mode at C = 200 with the
    pitch operand, dropout 0.05, against the port's plain version."""
    shape, ps = B2_BUILDS['c200_pitch']
    w, x, mask, cond, pitch, _ = _problem(shape, ps, [9, 6], 31)
    z_ref, ld_ref = JCG.fused_flow_stack_train(
        _jnp(x), _jnp(mask), _jnp(w), _jnp(cond), _jnp(pitch),
        seed=jnp.int32(SEED), dropout_rate=0.05, interpret=True)
    z, ld = tg.flow_stack_train(t(x), t(mask), {k: t(v) for k, v in w.items()},
                                t(cond), t(pitch), seed=SEED,
                                dropout_rate=0.05)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


# --- the padded forward, emulated in torch --------------------------------

def _stack(x, mask, weights, cond, pitch, drop):
    """The train stack of ``tg.flow_stack_train_reference`` in the dtype of
    its operands (float64 here, no rounding), with the dropout mask of
    layer ``i`` of step ``s`` ``drop(s, i)``: the plain version's loop,
    whose WaveNet width is that of the weights handed to it."""
    c2 = x.shape[-1] // 2
    ld = torch.zeros(x.shape[0], dtype=x.dtype)
    for s in range(weights['w_in'].shape[0]):
        y = (weights['an_bias'][s] + torch.exp(weights['an_logs'][s]) * x
             ) * mask
        yd = (y @ weights['mix_t'][s]) * mask
        xa, xb = yd[..., :c2], yd[..., c2:]
        mean, logs = tc.wavenet_stats(
            xa, mask, {key: value[s] for key, value in weights.items()},
            cond[s], pitch, torch.float32, b_in=weights['b_in'][s],
            drop=lambda i, s=s: drop(s, i).to(x.dtype))
        zb = (mean + torch.exp(logs) * xb) * mask
        ld = ld + (logs * mask).sum(dim=(1, 2))
        x = torch.cat([xa, zb], dim=-1)
    return x, ld + weights['ld_const'].sum() * mask.sum(dim=(1, 2))


# the weights (and operands) the forward reads at its padded WaveNet width
PADDED = ('w_start', 'b_start', 'w_in', 'b_in', 'w_rs', 'b_rs', 'w_end',
          'w_pitch', 'cond')


def _padded(key, value, ch_pad):
    return tc.padded_wavenet('b_rs' if key == 'b_in' else key, value,
                             ch_pad)


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 130), st.sampled_from([3, 5]))
def test_the_padded_forward_gives_the_unpadded_stack_exactly(ch, k):
    """The forward kernel's arithmetic at a padded WaveNet in float64:
    every WaveNet weight, b_in, the conditioning rows and w_pitch padded
    with zeros to the body's width (ch rounded up to 64), and each padded
    column's dropout bit drawn at its true column over the true 2ch
    (``dropmask.padded_stack_mask``, the twin of the kernel's
    ``true_column``).  z, the logdet and the gradient of every unpadded
    entry are the unpadded stack's to float64 rounding, and the gradients
    of every padded row and column are exactly zero.  The counters of the
    padded width itself would draw other masks."""
    shape = tc.FlowShape(16, ch, 2, k)
    ch_pad = tc.body_width(ch)
    w, x, mask, cond, pitch, zt = _problem(shape, 2, [7, 4, 1], ch + 50 * k)
    rate, (b, frames, c) = 0.3, x.shape
    f64 = {key: t(v).double() for key, v in {**w, 'cond': cond}.items()}
    x, mask, pitch, zt = (t(v).double() for v in (x, mask, pitch, zt))

    def true_drop(s, i):
        return dropmask.stack_mask(SEED, s, i, 2, b, frames, k, 2 * ch, rate)

    def padded_drop(s, i):
        return dropmask.padded_stack_mask(SEED, s, i, 2, b, frames, k, ch,
                                          ch_pad, rate)

    def loss(weights, drop):
        z, ld = _stack(x, mask, weights, weights['cond'], pitch, drop)
        return z, ld, torch.sum(z * zt) + 0.7 * torch.sum(ld)

    leaves = {key: v.clone().requires_grad_() for key, v in f64.items()}
    z, ld, total = loss(leaves, true_drop)
    total.backward()
    padded = {key: (_padded(key, v, ch_pad) if key in PADDED else v.clone()
                    ).requires_grad_() for key, v in f64.items()}
    z_pad, ld_pad, total_pad = loss(padded, padded_drop)
    total_pad.backward()
    assert torch.allclose(z_pad, z, rtol=1e-12, atol=1e-12)
    assert torch.allclose(ld_pad, ld, rtol=1e-12, atol=1e-10)
    for key, leaf in padded.items():
        if key not in PADDED:
            assert torch.allclose(leaf.grad, leaves[key].grad, rtol=1e-10,
                                  atol=1e-10), key
            continue
        real = _padded(key, torch.ones_like(f64[key]), ch_pad) != 0
        assert not leaf.grad[~real].any(), key
        assert torch.allclose(leaf.grad[real].reshape(f64[key].shape),
                              leaves[key].grad, rtol=1e-10, atol=1e-10), key
    # the masks at the true columns are the JAX layout's; the padded
    # width's own counters are not (at rate 0.3 some element differs)
    cols = dropmask.true_columns(ch, ch_pad)
    real = torch.cat([torch.arange(ch), ch_pad + torch.arange(ch)])
    assert torch.equal(cols[real], torch.arange(2 * ch))
    assert torch.equal(padded_drop(1, 1)[..., real], true_drop(1, 1))
    if ch != ch_pad:
        wrong = dropmask.stack_mask(SEED, 1, 1, 2, b, frames, k, 2 * ch_pad,
                                    rate)[..., real]
        assert not torch.equal(wrong, true_drop(1, 1))


# --- the forward's weights at the body's width ---------------------------

def _from_layout_bf16(packed):
    """``coupling.tensor_core_layout_bf16``'s inverse: ``[..., K/16, N/8,
    32, 4]`` → ``[..., K, N]`` float32."""
    *lead, kb, nb, _, _ = packed.shape
    d = len(lead)
    w = packed.float().reshape(*lead, kb, nb, 8, 4, 2, 2)
    # [kb, nb, g, t, h, e] -> [kb, h, t, e, nb, g]
    w = w.permute(*range(d), d, d + 4, d + 3, d + 5, d + 1, d + 2)
    return w.reshape(*lead, 16 * kb, 8 * nb)


@pytest.mark.parametrize('label', ['c16_ch16_l2_k5', 'c160_ch128_l16_k3'])
def test_the_forward_takes_its_weights_at_the_body_width(label):
    """What ``flow_stack_train`` hands #5 (``_kernel_weights``,
    ``_kernel_operands``): b_in, w_start, b_start, b_rs, w_end, the
    conditioning rows and w_pitch padded with zeros to the body's width,
    and w_in and w_rs in the f32 and the bf16 tensor-core layouts at it
    (gate columns interleaved), which unpack to the padded weights; the
    backward reads the unpadded ones."""
    shape, _ = B2_BUILDS[label]
    c, ch, n, k = shape
    ch_pad = tc.geometry(shape, train=True)['ch_pad']
    w, _, _, cond, _, _ = _problem(shape, 2, [3], 7)
    stack = [t(w[key]) for key in tg.WEIGHT_KEYS]
    for dtype in (torch.float32, torch.bfloat16):
        named = dict(zip(tg.WEIGHT_KEYS, tg._kernel_weights(stack, dtype)))
        for key in ('b_in', 'w_start', 'b_start', 'b_rs', 'w_end'):
            want = _padded(key, t(w[key]), ch_pad)
            if dtype == torch.bfloat16 and key in ('w_start', 'w_end'):
                want = want.to(torch.bfloat16).float()
            assert torch.equal(named[key], want), (key, dtype)
        if dtype == torch.bfloat16:
            w_in = _from_layout_bf16(named['w_in'])
            gates = w_in.reshape(2, n, k * ch_pad, ch_pad, 2)
            w_in = torch.cat([gates[..., 0], gates[..., 1]], dim=-1)
            w_rs = _from_layout_bf16(named['w_rs'])
            for got, key in ((w_in, 'w_in'), (w_rs, 'w_rs')):
                want = tc.padded_wavenet(key, t(w[key]), ch_pad)
                assert torch.equal(got.reshape(want.shape),
                                   want.to(torch.bfloat16).float()), key
        else:
            assert named['w_in'].shape == (2, n, k * ch_pad // 8, ch_pad // 4,
                                           32, 4)
    w_pitch = torch.randn(2, n, 2, 2 * ch)
    rows, wp = tg._kernel_operands(t(cond), w_pitch, ch)
    assert torch.equal(rows, tc.padded_wavenet('cond', t(cond), ch_pad))
    assert torch.equal(wp, tc.padded_wavenet('w_pitch', w_pitch, ch_pad))
