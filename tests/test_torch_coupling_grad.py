"""The train-direction flow stack of the port on the CPU
(``glow_tts_tpu_torch/ops/coupling_grad.py``; a CPU tensor takes the plain
version, differentiated by autograd) against the JAX package's
``flow_stack_train_reference`` and against its Pallas kernel pair
``fused_flow_stack_train(..., interpret=True)``: ``z``, ``logdet``, ``dx``,
every weight gradient and ``dcond``, at dropout rate 0 and 0.3 (the masks
are bit-equal, so dropout adds no tolerance), with and without ``cond``,
ragged masks.

Tolerances are those of ``tests/test_coupling_train.py`` (both sides f32,
sums in another order): z rtol/atol 2e-5, logdet rtol 2e-5 / atol 2e-4,
gradients rtol/atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu_torch.ops import coupling as TC
from glow_tts_tpu_torch.ops import coupling_grad as TCG
from tests.torch_port_helpers import ragged, t

Z_TOL = dict(rtol=2e-5, atol=2e-5)
LD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
S, N, K, CH, C = 3, 2, 5, 16, 16
SEED = 1234


def _weights(rng, pitch_size=None):
    c2, ch2 = C // 2, 2 * CH
    shapes = [
        ('w_start', (S, c2, CH), .3), ('b_start', (S, CH), .1),
        ('w_in', (S, N, K, CH, ch2), .2), ('w_rs', (S, N, CH, ch2), .2),
        ('b_rs', (S, N, ch2), .1), ('w_end', (S, CH, C), .2),
        ('b_end', (S, C), .1), ('b_in', (S, N, ch2), .1),
        ('an_logs', (S, C), .1), ('an_bias', (S, C), .1),
        ('mix_t', (S, C, C), .2), ('ld_const', (S,), .1)]
    if pitch_size:
        shapes.append(('w_pitch', (S, N, pitch_size, ch2), .2))
    return {key: (rng.standard_normal(shape) * scale).astype(np.float32)
            for key, shape, scale in shapes}


def _problem(seed, lengths, conditioning):
    rng = np.random.default_rng(seed)
    b, frames = len(lengths), max(lengths)
    x, mask = ragged(rng, b, frames, C, lengths)
    weights = _weights(rng, 2 if conditioning == 'pitch' else None)
    cond = ((rng.standard_normal((S, N, b, 2 * CH)) * .2).astype(np.float32)
            if conditioning == 'cond' else None)
    pitch = ((rng.standard_normal((b, frames, 2)).astype(np.float32)) * mask
             if conditioning == 'pitch' else None)
    z_weight = rng.standard_normal((b, frames, C)).astype(np.float32)
    return x, mask, weights, cond, pitch, z_weight


def _jnp(value):
    if isinstance(value, dict):
        return {key: jnp.asarray(v) for key, v in value.items()}
    return None if value is None else jnp.asarray(value)


def _leaf(value):
    return None if value is None else t(value).requires_grad_()


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('conditioning', ['none', 'cond', 'pitch'])
@pytest.mark.parametrize('oracle', ['twin', 'pallas'])
def test_forward_matches_jax(rate, conditioning, oracle):
    x, mask, weights, cond, pitch, _ = _problem(0, [13, 12, 8, 5, 2],
                                                conditioning)
    fn = (JCG.flow_stack_train_reference if oracle == 'twin' else
          lambda *a, **kw: JCG.fused_flow_stack_train(*a, interpret=True,
                                                      **kw))
    z_ref, ld_ref = fn(_jnp(x), _jnp(mask), _jnp(weights), _jnp(cond),
                       _jnp(pitch), seed=jnp.int32(SEED), dropout_rate=rate)
    z, ld = TCG.flow_stack_train(
        t(x), t(mask), {key: t(v) for key, v in weights.items()},
        None if cond is None else t(cond),
        None if pitch is None else t(pitch), seed=SEED, dropout_rate=rate)
    assert z.dtype == ld.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)
    assert (z.numpy()[np.broadcast_to(mask, z.shape) == 0] == 0).all()


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('conditioning', ['none', 'cond', 'pitch'])
@pytest.mark.parametrize('oracle', ['twin', 'pallas'])
def test_gradients_match_jax(rate, conditioning, oracle):
    """A loss that touches z and the logdet (a weight per sample, so that
    ``dld`` differs between samples)."""
    seed = -77                                  # a negative int32 seed
    x, mask, weights, cond, pitch, zt = _problem(1, [11, 7, 4], conditioning)
    ld_weight = np.arange(1., 4.).astype(np.float32)
    fn = (JCG.flow_stack_train_reference if oracle == 'twin' else
          lambda *a, **kw: JCG.fused_flow_stack_train(*a, interpret=True,
                                                      **kw))

    def jax_loss(w_, x_, c_, p_):
        z, ld = fn(x_, _jnp(mask), w_, c_, p_, seed=jnp.int32(seed),
                   dropout_rate=rate)
        return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight)

    argnums = [0, 1] + ([2] if cond is not None else []) \
        + ([3] if pitch is not None else [])
    ref = dict(zip(argnums, jax.grad(jax_loss, argnums=argnums)(
        _jnp(weights), _jnp(x), _jnp(cond), _jnp(pitch))))

    tw = {key: _leaf(v) for key, v in weights.items()}
    tx, tcond, tpitch = _leaf(x), _leaf(cond), _leaf(pitch)
    z, ld = TCG.flow_stack_train(tx, t(mask), tw, tcond, tpitch, seed=seed,
                                 dropout_rate=rate)
    (torch.sum(z * t(zt)) + 0.7 * torch.sum(ld * t(ld_weight))).backward()

    for key in weights:
        np.testing.assert_allclose(tw[key].grad.numpy(),
                                   np.asarray(ref[0][key]), **GRAD_TOL,
                                   err_msg=f'weight grad {key}')
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[1]),
                               **GRAD_TOL, err_msg='dx')
    if cond is not None:
        np.testing.assert_allclose(tcond.grad.numpy(), np.asarray(ref[2]),
                                   **GRAD_TOL, err_msg='dcond')
    if pitch is not None:
        np.testing.assert_allclose(tpitch.grad.numpy(), np.asarray(ref[3]),
                                   **GRAD_TOL, err_msg='dpitch')


def test_dropout_changes_the_output_and_is_a_function_of_the_seed():
    x, mask, weights, _, _, _ = _problem(2, [9, 6], 'none')
    tw = {key: t(v) for key, v in weights.items()}

    def run(seed, rate=0.3):
        return TCG.flow_stack_train(t(x), t(mask), tw, seed=seed,
                                    dropout_rate=rate)[0]

    assert torch.equal(run(5), run(5))
    assert (run(5) - run(6)).abs().max() > 1e-4
    assert (run(5) - run(5, 0.0)).abs().max() > 1e-4


def test_wrapper_refuses_a_rate_outside_the_unit_interval():
    x, mask, weights, _, _, _ = _problem(3, [4], 'none')
    tw = {key: t(v) for key, v in weights.items()}
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match='dropout_rate'):
            TCG.flow_stack_train(t(x), t(mask), tw, seed=0,
                                 dropout_rate=rate)


# ---------------------------------------------------------------------------
# what the CUDA backward's design rests on, shown without the card
# ---------------------------------------------------------------------------

def _per_sample_gradients(x, mask, weights, cond, zt, ld_weight, lengths):
    """Gradients of the loss of each sample alone, trimmed to its length
    (no padded frame exists), summed over the samples for the weights and
    put back at the sample's frames for ``dx`` and ``dcond``."""
    total = {key: np.zeros_like(v) for key, v in weights.items()}
    dx = np.zeros_like(x)
    dcond = None if cond is None else np.zeros_like(cond)
    for b, n in enumerate(lengths):
        tw = {key: _leaf(v) for key, v in weights.items()}
        tx = _leaf(x[b:b + 1, :n])
        tcond = None if cond is None else _leaf(cond[:, :, b:b + 1])
        z, ld = TCG.flow_stack_train_reference(
            tx, t(mask[b:b + 1, :n]), tw, tcond, seed=SEED, dropout_rate=0.0)
        (torch.sum(z * t(zt[b:b + 1, :n]))
         + 0.7 * torch.sum(ld * float(ld_weight[b]))).backward()
        for key in weights:
            total[key] += tw[key].grad.numpy()
        dx[b, :n] = tx.grad.numpy()[0]
        if cond is not None:
            dcond[:, :, b] = tcond.grad.numpy()[:, :, 0]
    return total, dx, dcond


def _assert_close_to_scale(got, ref, rtol, name):
    """rtol on every element plus the same fraction of the tensor's max-abs
    (f32 sums in another order leave that much on elements near zero)."""
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize('conditioning', ['none', 'cond'])
@pytest.mark.parametrize('lengths', [[13, 7, 4], [9, 1, 9, 5]])
def test_ragged_batch_gradients_are_the_valid_frames_alone(lengths,
                                                           conditioning):
    """The premise of skipping frames past a sample's length: they add
    nothing to any gradient, so the batch's gradients are those of every
    sample alone, trimmed to its length, summed."""
    x, mask, weights, cond, _, zt = _problem(4, lengths, conditioning)
    ld_weight = np.arange(1., len(lengths) + 1.).astype(np.float32)
    tw = {key: _leaf(v) for key, v in weights.items()}
    tx, tcond = _leaf(x), _leaf(cond)
    z, ld = TCG.flow_stack_train_reference(tx, t(mask), tw, tcond, seed=SEED,
                                           dropout_rate=0.0)
    (torch.sum(z * t(zt)) + 0.7 * torch.sum(ld * t(ld_weight))).backward()
    total, dx, dcond = _per_sample_gradients(x, mask, weights, cond, zt,
                                             ld_weight, lengths)
    for key in weights:
        _assert_close_to_scale(tw[key].grad.numpy(), total[key], 1e-5, key)
    _assert_close_to_scale(tx.grad.numpy(), dx, 1e-5, 'dx')
    assert (tx.grad.numpy()[np.broadcast_to(mask, x.shape) == 0] == 0).all()
    if cond is not None:
        _assert_close_to_scale(tcond.grad.numpy(), dcond, 1e-5, 'dcond')


@pytest.mark.parametrize('conditioning', ['none', 'cond'])
def test_jax_ragged_batch_gradients_are_the_valid_frames_alone(conditioning):
    """The JAX reference on the same numpy inputs agrees with the sum of the
    port's per-sample gradients."""
    lengths = [13, 7, 4]
    x, mask, weights, cond, _, zt = _problem(4, lengths, conditioning)
    ld_weight = np.arange(1., len(lengths) + 1.).astype(np.float32)

    def jax_loss(w_, x_, c_):
        z, ld = JCG.flow_stack_train_reference(
            x_, _jnp(mask), w_, c_, None, seed=jnp.int32(SEED),
            dropout_rate=0.0)
        return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight)

    argnums = [0, 1] + ([2] if cond is not None else [])
    ref = dict(zip(argnums, jax.grad(jax_loss, argnums=argnums)(
        _jnp(weights), _jnp(x), _jnp(cond))))
    total, dx, dcond = _per_sample_gradients(x, mask, weights, cond, zt,
                                             ld_weight, lengths)
    for key in weights:
        np.testing.assert_allclose(total[key], np.asarray(ref[0][key]),
                                   **GRAD_TOL, err_msg=key)
    np.testing.assert_allclose(dx, np.asarray(ref[1]), **GRAD_TOL)
    if cond is not None:
        np.testing.assert_allclose(dcond, np.asarray(ref[2]), **GRAD_TOL)


def test_tf32_round_is_round_to_nearest_ties_away_on_ten_bits():
    x = t(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    r = TCG.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(TCG.tf32_round(r), r)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    # a tie (the 13 dropped bits are 1 0...0) goes away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(TCG.tf32_round(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))
    # the remainder of the split is exact in f32 and small
    assert ((x - r) + r).eq(x).all()


@pytest.mark.parametrize('passes,within', [(3, True), (1, False)])
@pytest.mark.parametrize('depth', [16384, 960])
def test_3xtf32_product_keeps_f32_accuracy_and_one_pass_does_not(depth,
                                                                 passes,
                                                                 within):
    """The arithmetic of the backward GEMMs at the depths they contract
    over (16,384 frames for a weight gradient, 960 for the k-tap conv's
    activation gradient): against the f32 product, relative to its max-abs,
    3xTF32 is within 1e-5 and a single TF32 pass is not."""
    rng = np.random.default_rng(depth)
    a = t(rng.standard_normal((48, depth)).astype(np.float32))
    b = t(rng.standard_normal((depth, 64)).astype(np.float32))
    exact = a @ b
    got = TCG.matmul_3xtf32_reference(a, b, passes)
    err = ((got - exact).abs().max() / exact.abs().max()).item()
    assert (err < 1e-5) == within, err


PER_FRAME_BYTES = 4 * (160 + 160 + 4 * 192 + 4 * 384 + 192 + 80)


@pytest.mark.parametrize('steps,frames,stores', [
    (12, 32 * 512, True),            # the training shape: 2.3 GB
    (12, 61794, True), (12, 61795, False),
    (1, 741534, True), (1, 741535, False),
    (48, 32 * 512, False)])
def test_store_or_recompute_is_a_function_of_the_shapes(steps, frames,
                                                        stores):
    assert TCG.saved_bytes_per_step(frames, 160, 192, 4) \
        == frames * PER_FRAME_BYTES
    assert (steps * frames * PER_FRAME_BYTES <= 8 * 2 ** 30) == stores
    assert TCG.stores_activations(steps, frames, 160, 192, 4) == stores


def test_saved_bytes_are_those_of_the_buffers():
    for steps in (None, 3):
        buffers = TCG._saved_buffers(24, C, CH, N, 'cpu', steps)
        assert tuple(buffers) == TCG.SAVED_KEYS
        assert sum(4 * v.numel() for v in buffers.values()) \
            == (steps or 1) * TCG.saved_bytes_per_step(24, C, CH, N)


def test_valid_lengths_are_one_past_the_last_valid_frame():
    mask = np.zeros((4, 6, 1), np.float32)
    mask[0, :6] = 1
    mask[1, :1] = 1
    mask[3, [0, 1, 4]] = 1           # not a prefix: frames up to 4 count
    lengths = TCG._valid_lengths(t(mask))
    assert lengths.dtype == torch.int32
    assert lengths.tolist() == [6, 1, 0, 5]


def test_backward_launch_count_is_fixed_by_the_layer_count():
    assert TCG.backward_launches_per_step(4) == 22
    assert TCG.backward_launches_per_step(1) == 10


@pytest.mark.parametrize('k', [1, 3, 5])
def test_the_wavenets_tap_conv_is_the_padded_convolution(k):
    """``ops.coupling.tap_conv`` (one product a tap) is the 'same'-padded
    convolution the WaveNet's in-layers compute, to float32 rounding."""
    rng = np.random.default_rng(k)
    h = t(rng.standard_normal((3, 11, 6)).astype(np.float32))
    w = t(rng.standard_normal((k, 6, 10)).astype(np.float32))
    ref = torch.nn.functional.conv1d(h.transpose(1, 2), w.permute(2, 1, 0),
                                     padding=(k - 1) // 2).transpose(1, 2)
    np.testing.assert_allclose(TC.tap_conv(h, w).numpy(), ref.numpy(),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('stack', ['train', 'forward', 'inverse'])
def test_the_plain_stacks_take_no_cudnn_convolution(stack, monkeypatch):
    """The plain stacks (which run the model under tensor parallelism)
    make no ``conv1d`` call, so cuDNN's TF32 default on a card cannot
    reach their float32 products; with ``conv1d`` refused they still
    compute."""
    def refused(*args, **kwargs):
        raise AssertionError('conv1d called')

    x, mask, weights, cond, _, _ = _problem(3, [9, 7, 4], 'cond')
    w = {key: t(v) for key, v in weights.items()}
    monkeypatch.setattr(torch.nn.functional, 'conv1d', refused)
    monkeypatch.setattr(torch, 'conv1d', refused)
    if stack == 'train':
        z, ld = TCG.flow_stack_train_reference(t(x), t(mask), w, t(cond),
                                               seed=SEED, dropout_rate=0.3)
    else:
        del w['b_in']
        z, ld = TC.flow_stack_reference(t(x), t(mask), w, t(cond),
                                        reverse=stack == 'inverse')
    assert torch.isfinite(z).all()
    assert (ld is None) == (stack == 'inverse')
