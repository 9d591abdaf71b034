"""The deterministic flow kernels (#2 ``coupling``, #3 ``flow_step``, #4
``flow_stack``) at decoder shapes besides the shipped 160/80 x 192·4·k5
(ROADMAP B.2), on the CPU:

* the envelope (``ops/coupling.py::check_envelope``): accepted shapes make
  their build's macros and geometry, others raise naming B.2, and the
  train kernels (#5, #6) take these shapes too and refuse those over
  their budget (``tests/test_torch_b2_train.py`` holds the rest);
* the geometry function against the values the shipped builds had;
* the padded packers (the float32 body's tensor-core layout, the ring
  body's slices, the copies read as they lie): unpacked through a torch
  emulation of the products the kernels run, they give the unpadded
  weights exactly and zeros in every padded row and column, over a
  ``hypothesis`` sweep of the envelope;
* the weight bridge (``weights.py``) at C = 200 and at (C 160, ch 128, 16
  layers, k 3);
* the port's flow step and coupling (the kernels' plain versions) against
  the JAX package's Pallas kernels in interpret mode at C = 200 (B = 1,
  T_f = 16, one step), and the port's ``AffineCoupling`` and
  ``FlowDecoder`` (every route's plain version) against the flax modules
  at both shapes.

Tolerances: ``tests/test_torch_coupling.py``'s (z rtol 3e-5 / atol 3e-6,
logdet rtol 3e-5 / atol 1e-4) at float32; the bf16 bar of
``tests/torch_port_helpers.py`` (twice the JAX package's own bf16 error)
at bfloat16."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from glow_tts_tpu.models import decoder as jd
from glow_tts_tpu.ops.coupling import fused_coupling, fused_flow_step
from glow_tts_tpu_torch.ops import bf16_tiles as bt
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.weights import (convert_params_to_reference,
                                        reference_to_params)
from tests.helpers import tiny_config
from tests.test_torch_coupling import _weights as _unit_weights
from tests.torch_port_helpers import (assert_bf16_close, port_config,
                                      port_model, ragged, t, with_backend)

Z_TOL = dict(rtol=3e-5, atol=3e-6)
LD_TOL = dict(rtol=3e-5, atol=1e-4)
# the shapes this slice builds besides the shipped two, and the JAX
# configs (tiny_config's encoder) of the two held against the JAX package
B2_SHAPES = {'c200': tc.FlowShape(200),
             'c16_ch16_l2_k5': tc.FlowShape(16, 16, 2, 5),
             'c160_ch128_l16_k3': tc.FlowShape(160, 128, 16, 3)}
JAX_SHAPES = {'c200': (100, 192, 4, 5), 'c160_ch128_l16_k3': (80, 128, 16, 3)}
# the envelope, as hypothesis draws it: C a multiple of 4 from 8 to 256, ch
# up to 192, k odd, the halo n (k - 1) / 2 at most 16
ENVELOPE_SHAPES = st.builds(
    lambda c4, ch, n, half: tc.FlowShape(4 * c4, ch, n, 2 * half + 1),
    st.integers(2, 64), st.integers(1, 192), st.integers(1, 16),
    st.integers(0, 8)).filter(lambda s: s.halo <= 16)


# --- the envelope and the builds ------------------------------------------

@pytest.mark.parametrize('label', list(B2_SHAPES))
def test_the_b2_shapes_are_in_the_envelope_and_name_their_builds(label):
    shape = B2_SHAPES[label]
    assert tc.check_envelope('flow_step', shape) == shape
    for bf16 in (False, True):
        assert tc.budget_error(shape, bf16) is None
        defines = tc.build_defines(shape, False, bf16)
        # every macro that differs from the shipped shape, and no other
        macros = dict(d.split('=') for d in defines if '=' in d)
        assert macros == {macro: str(getattr(shape, field))
                          for field, macro in tc.SHAPE_MACROS
                          if getattr(shape, field)
                          != getattr(tc.SHIPPED_SHAPE, field)}
        assert ('GLOW_BF16' in defines) == bf16
    assert tc.shape_tag(shape) == label
    assert tc.build_tag(shape, 2) == f'{label}_pitch'
    assert tc.count_suffix(shape, False, True) == f'bf16_{label}_launches'
    # GR's pitch operand: num_squeeze wide, named in the build but where
    # it is the 160- or 80-channel build's own
    assert tc.build_defines(shape, 2)[:1] == ('GLOW_PITCH',)
    for ps in (1, 2):
        named = f'GLOW_PITCH_SIZE={ps}' in tc.build_defines(shape, ps)
        assert named == (tc.SHIPPED_PITCH_SIZE.get(shape.channels) != ps)


@settings(max_examples=60, deadline=None)
@given(ENVELOPE_SHAPES)
def test_every_shape_of_the_envelope_is_taken_or_refused_by_its_budget(
        shape):
    """Inside the envelope every body fits a block at both dtypes, with and
    without a pitch operand: the ring body owns fewer frames a tile where
    it needs the room (32 to 48, the tile with its halo within 64 rows),
    so no budget refuses a shape and check_envelope takes it."""
    assert tc.check_envelope('flow_step', shape) == shape
    for bf16 in (False, True):
        for pitch in (0, 2):
            assert tc.budget_error(shape, bf16, pitch) is None
            assert tc.check_envelope('flow_step', shape, pitch,
                                     bf16) == shape
            g = tc.geometry(shape, bf16, pitch)
            assert g['block_bytes'] <= tc.BLOCK_BYTES
            if bf16:
                assert 32 <= g['time_tile'] <= 48
                assert g['time_tile'] + 2 * shape.halo <= 64


@pytest.mark.parametrize('shape', [
    (102, 192, 4, 5),        # C not a multiple of 4 (ROADMAP B.2)
    (264, 192, 4, 5),        # C over 256
    (160, 256, 4, 5),        # ch over 192
    (160, 192, 4, 4),        # an even k
    (160, 192, 9, 5),        # a halo of 18
    (160, 192, 0, 5)])       # no layer
def test_shapes_outside_the_envelope_raise_naming_b2(shape):
    with pytest.raises(ValueError, match='ROADMAP.md B.2'):
        tc.check_envelope('flow_step', shape)
    with pytest.raises(ValueError, match='ROADMAP.md B.2'):
        tc.check_shape('coupling', shape[0], (shape[2], shape[3], shape[1],
                                              2 * shape[1]))


@pytest.mark.parametrize('label', list(B2_SHAPES))
def test_the_train_kernels_refuse_other_shapes_naming_b2s_train_half(label):
    """The train kernels take every B.2 shape (and the shipped two) at
    both dtypes, with and without the pitch operand, and C = 200 at 8
    layers of the shipped WaveNet, whose saving stage has no room (#5
    stores from its registers there); they refuse, naming B.2's train
    half, the shapes whose saved rows their stores do not take (ch 20 at
    bf16, ch 10 at f32) and those outside the envelope (C = 102)."""
    c, ch, n, k = B2_SHAPES[label]
    for bf16 in (False, True):
        for ps in (0, 2):
            assert tc.check_train_shape('flow_stack_train', c,
                                        (n, k, ch, 2 * ch), ps,
                                        bf16) == B2_SHAPES[label]
    for c in tc.BUILT_CHANNELS:
        tc.check_train_shape('flow_stack_train', c, (4, 5, 192, 384),
                             tc.SHIPPED_PITCH_SIZE[c])
    for bf16 in (False, True):
        assert tc.check_train_shape('flow_stack_train', 200,
                                    (8, 5, 192, 384), 0,
                                    bf16) == (200, 192, 8, 5)
    for (c, ch, n, k), bf16 in (((160, 10, 2, 5), False),
                                ((102, 192, 4, 5), True),
                                ((160, 20, 2, 5), True)):
        with pytest.raises(ValueError, match='B.2, the train half'):
            tc.check_train_shape('flow_stack_train', c, (n, k, ch, 2 * ch),
                                 0, bf16)


def test_the_geometry_is_the_shipped_builds_constants():
    """At 160 and 80 channels the geometry is what the shipped builds were
    compiled with: 32-frame tiles in the float32 body (138 KB of buffers
    at 160), 48-frame tiles in the ring body (206 KB at 160), 64-deep
    slices, 96-column halves of the 1x1s, 192 of the WaveNet products;
    and the module's constants are its values."""
    assert (tc.TIME_TILE, tc.RING_TIME_TILE) == (32, 48)
    assert (tc.RING_DEPTH, tc.RING_HALF_SMALL, tc.RING_HALF_BIG) == (64, 96,
                                                                     192)
    for c in tc.BUILT_CHANNELS:
        f32, ring = tc.geometry(c), tc.geometry(c, True)
        assert (f32['time_tile'], f32['ch_pad'], f32['ring_depth']) == (32,
                                                                       192, 0)
        assert (ring['time_tile'], ring['ch_pad'], ring['ring_depth'],
                ring['half_small'], ring['half_big']) == (48, 192, 64, 96,
                                                          192)
        # the pitch builds stage w_pitch, as they always have
        assert tc.geometry(c, False, tc.SHIPPED_PITCH_SIZE[c])[
            'stage_w_pitch'] == 1
        assert tc.geometry(c, True, tc.SHIPPED_PITCH_SIZE[c])[
            'stage_w_pitch'] == 1
    assert tc.geometry(160)['smem_bytes'] == 138048
    assert tc.geometry(160, True)['smem_bytes'] == 206144
    # and the names and hashes' inputs of the shipped builds
    assert tc.build_defines(80, True, True) == ('GLOW_PITCH',
                                                'GLOW_CHANNELS=80',
                                                'GLOW_BF16')
    assert tc.build_tag(80, True) == 'c80_pitch'


def test_the_pitch_width_is_num_squeeze():
    cfg = tiny_config('GR')
    assert tc.pitch_width(cfg) == cfg.decoder.num_squeeze == 2
    assert tc.pitch_width(dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, num_squeeze=1))) == 1


# --- the padded packers ---------------------------------------------------

def _product_weights(shape, seed):
    """One flow step's product weights at ``shape``, float32."""
    rng = np.random.default_rng(seed)
    c, ch, n, k = shape

    def randn(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(np.float32))
    return {'mix_t': randn(c, c), 'w_start': randn(c // 2, ch),
            'b_start': randn(ch), 'w_in': randn(n, k, ch, 2 * ch),
            'w_rs': randn(n, ch, 2 * ch), 'b_rs': randn(n, 2 * ch),
            'w_end': randn(ch, c), 'w_pitch': randn(n, 2, 2 * ch)}


def _ring_dense(packed, nw, rows):
    """The dense ``[depth, columns]`` weight a ring product multiplies by:
    each slice read back as every warpgroup's ``wgmma`` B operand
    (``bt.ring_slice_operand``), the product ``I · B`` of the identity."""
    depth = packed.shape[0] * tc.RING_DEPTH
    out = torch.zeros((depth, 2 * nw * 96), dtype=torch.float64)
    for s in range(packed.shape[0]):
        image = packed[s].flatten()
        for wg in (0, 1):
            for j in range(nw):
                for kk in range(tc.RING_DEPTH // 16):
                    b = bt.ring_slice_operand(image, wg, nw, j, kk).double()
                    ks = tc.RING_DEPTH * s + 16 * kk
                    cols = (wg * nw + j) * 96
                    out[ks:ks + 16, cols:cols + 96] = b.T
    assert out.shape[1] == rows
    return out


def _want_ring(w, half):
    """``w [K, N]`` (N two halves) rounded to bfloat16, as the ring lays it
    out: each half at ``h · half``, zeros elsewhere (float64)."""
    k, n = w.shape
    out = torch.zeros((k, 2 * half), dtype=torch.float64)
    r = w.to(torch.bfloat16).double()
    out[:, :n // 2] = r[:, :n // 2]
    out[:, half:half + n // 2] = r[:, n // 2:]
    return out


@settings(max_examples=10, deadline=None)
@given(ENVELOPE_SHAPES.filter(lambda s: s.n_layers <= 4
                              and s.kernel_size <= 5))
def test_the_ring_slices_give_the_unpadded_products_exactly(shape):
    """The ring body's slices (``ring_weights``) read back through the
    twin of the ``wgmma`` operand the kernel reads (the identity's
    product): the unpadded weight, rounded, in each product's columns, and
    zeros in every padded depth and column (the WaveNet at 192)."""
    c, ch, n, k = shape
    w = _product_weights(shape, shape.channels + ch)
    ring = tc.ring_weights(w)
    shapes = tc.ring_shapes(c, n, k, ch)
    for key, tensor in ring.items():
        assert tuple(tensor.shape) == shapes[key], key
    g = tc.geometry(shape, True)
    hs, chp = g['half_small'], g['ch_pad']
    padded = {key: tc.padded_wavenet(key, w[key], chp)
              for key in ('w_start', 'w_in', 'w_rs', 'w_end')}
    cases = {'mix_ring': (w['mix_t'], hs, ring['mix_ring']),
             'start_ring': (padded['w_start'], 96, ring['start_ring']),
             'end_ring': (padded['w_end'], hs, ring['end_ring'])}
    for i in (0, n - 1):
        cases[f'in_ring {i}'] = (tc.interleave_gate(padded['w_in'])[i], 192,
                                 ring['in_ring'][i])
        cases[f'rs_ring {i}'] = (padded['w_rs'][i], 192, ring['rs_ring'][i])
    for name, (dense, half, packed) in cases.items():
        got = _ring_dense(packed, half // 96, 2 * half)
        want = _want_ring(dense, half)
        assert torch.equal(got[:dense.shape[0]], want), name
        assert not got[dense.shape[0]:].any(), name
    # the padded WaveNet's own zeros: rows and columns past ch
    assert not padded['w_in'][..., ch:, :].any()
    assert not padded['w_in'][..., :, ch:chp].any()
    assert not padded['w_in'][..., :, chp + ch:].any()
    assert torch.equal(padded['w_in'][..., :ch, :ch], w['w_in'][..., :ch])
    assert torch.equal(padded['w_in'][..., :ch, chp:chp + ch],
                       w['w_in'][..., ch:])


def _from_tensor_core_layout(w_tc):
    """``[..., K/8, N/8, 32, 4]`` TF32 (hi, hi', lo, lo') pairs back to
    ``[..., K, N]`` = hi + lo, as the float32 body's mma B fragments hold
    them: lane 4g + t of block (kb, nb) rows 8kb + t and + 4 of column
    8nb + g."""
    *lead, kb, nb, _, _ = w_tc.shape
    lanes = w_tc.reshape(*lead, kb, nb, 8, 4, 4)      # [.., kb, nb, g, t, 4]
    w = lanes[..., :2] + lanes[..., 2:]               # rows t and t + 4
    d = len(lead)
    # [.., kb, nb, g, t, h] -> [.., kb, h, t, nb, g]
    w = w.permute(*range(d), d, d + 4, d + 3, d + 1, d + 2)
    return w.reshape(*lead, 8 * kb, 8 * nb)


@settings(max_examples=12, deadline=None)
@given(ENVELOPE_SHAPES)
def test_the_float32_packs_give_the_unpadded_products_exactly(shape):
    """The float32 body's weights at its WaveNet width (ch padded to a
    multiple of 64): the tensor-core layout of w_in and w_rs unpacked as
    the mma fragments hold them, and the copies it reads as they lie, are
    the unpadded weights exactly in their rows and columns and zeros in
    every padded one; the conditioning rows are padded the same way."""
    c, ch, n, k = shape
    w = _product_weights(shape, shape.channels * 7 + ch)
    chp = tc.geometry(shape)['ch_pad']
    assert chp % 64 == 0 and chp - 64 < ch <= chp
    packed = tc.with_tensor_core_weights(w)
    w_in = _from_tensor_core_layout(packed['w_in_tc'])
    gates = w_in.reshape(n, k, chp, chp, 2)           # interleaved columns
    w_in = torch.cat([gates[..., 0], gates[..., 1]], dim=-1)
    w_rs = _from_tensor_core_layout(packed['w_rs_tc'])
    for got, key in ((w_in, 'w_in'), (w_rs, 'w_rs')):
        assert torch.equal(got, tc.padded_wavenet(key, w[key], chp)), key
    pads = tc.padded_weights(w, chp)
    assert set(pads) == (set() if ch == chp else
                         {tc.padded_key(key) for key in tc.PAD_KEYS})
    for key in tc.PAD_KEYS:
        if ch == chp:
            continue
        got = pads[tc.padded_key(key)]
        assert got.shape == tc.padded_wavenet(key, w[key], chp).shape
        # the unpadded values in place, zeros around them
        real = torch.zeros_like(got, dtype=torch.bool)
        if key in ('w_start', 'b_start'):
            real[..., :ch] = True
        elif key == 'w_end':
            real[:ch] = True
        else:
            real[..., :ch] = True
            real[..., chp:chp + ch] = True
        assert not got[~real].any(), key
        assert torch.equal(got[real], w[key].flatten() if key in (
            'w_start', 'b_start', 'w_end') else w[key].flatten()), key
    cond = torch.randn(n, 3, 2 * ch)
    padded = tc.kernel_cond(cond, chp)
    assert torch.equal(padded[..., :ch], cond[..., :ch])
    assert torch.equal(padded[..., chp:chp + ch], cond[..., ch:])


@pytest.mark.parametrize('label', list(B2_SHAPES))
def test_padded_weights_leave_the_plain_wavenet_equal(label):
    """The plain WaveNet on the padded weights and conditioning rows (each
    body's width) gives the unpadded mean and logs: the padded channels
    carry exact zeros (checked in float64, where every product is exact up
    to the sums' order)."""
    shape = B2_SHAPES[label]
    c, ch, n, k = shape
    w = {key: value.double() for key, value in
         _product_weights(shape, 3).items()}
    w['b_end'] = torch.randn(c, dtype=torch.float64)
    rng = np.random.default_rng(4)
    x_a = torch.from_numpy(rng.standard_normal((2, 24, c // 2)))
    mask = torch.ones(2, 24, 1, dtype=torch.float64)
    mask[1, 17:] = 0
    cond = torch.from_numpy(rng.standard_normal((n, 2, 2 * ch)) * .2)
    # (float64 tensors at the float32 policy: nothing rounded)
    mean, logs = tc.wavenet_stats(x_a, mask, w, cond)
    for bf16 in (False, True):
        chp = tc.geometry(shape, bf16)['ch_pad']
        padded = {key: tc.padded_wavenet(key, value, chp)
                  for key, value in w.items()}
        mean_p, logs_p = tc.wavenet_stats(
            x_a, mask, padded, tc.kernel_cond(cond, chp))
        torch.testing.assert_close(mean_p, mean, rtol=0, atol=1e-12)
        torch.testing.assert_close(logs_p, logs, rtol=0, atol=1e-12)


# --- the weight bridge, and the JAX package --------------------------------

def _jax_config(label):
    mel, ch, n, k = JAX_SHAPES[label]
    sound = {'Mel_Dim': mel, 'Spectrogram_Dim': 65, 'Frame_Length': 64,
             'Frame_Shift': 16, 'Sample_Rate': 1600}
    decoder = {'Stack': 2, 'Num_Squeeze': 2, 'Num_Split': 4,
               'Affine_Coupling': {'Calc_Channels': ch, 'WaveNet': {
                   'Num_Layers': n, 'Kernel_Size': k,
                   'Dropout_Rate': 0.05}}}
    return tiny_config(Sound=sound, Decoder=decoder)


@pytest.fixture(scope='module', params=list(JAX_SHAPES))
def b2_model(request):
    """(label, JAX config, JAX params, reference state dict, port model)
    at a B.2 shape: the port's seeded weights (a nonzero end conv) as the
    reference state dict, and the JAX params the weight bridge makes of
    it."""
    from glow_tts_tpu_torch import random_state_dict
    cfg = _jax_config(request.param)
    pcfg = port_config(cfg)
    sd = {key: value.detach().numpy().copy()
          for key, value in random_state_dict(pcfg, 23).items()}
    assert all(np.isfinite(value).all() for value in sd.values())
    params = reference_to_params(sd, pcfg)
    return request.param, cfg, params, sd, port_model(cfg, params)


def test_the_weight_bridge_round_trips_at_the_b2_shapes(b2_model):
    """The reference state dict -> JAX params -> the reference state dict
    (the bridge both ways, ``weights.py``) gives the same numbers at the
    B.2 shape's widths, and the port loads them."""
    label, cfg, params, sd, port = b2_model
    shape = tc.config_shape(port.config)
    assert tuple(shape) == {'c200': (200, 192, 4, 5),
                            'c160_ch128_l16_k3': (160, 128, 16, 3)}[label]
    again = convert_params_to_reference(params, port.config)
    assert set(again) == set(sd)
    for key, value in again.items():
        np.testing.assert_array_equal(np.asarray(value), sd[key],
                                      err_msg=key)
    wavenet = port.layer_Dict['Decoder'].layer_Dict['Flows'][0].layers[2]
    assert wavenet.pack()[0]['w_in'].shape == (
        shape.n_layers, shape.kernel_size, shape.ch, 2 * shape.ch)


@pytest.mark.parametrize('reverse', [False, True])
def test_the_coupling_module_matches_flax_at_the_b2_shapes(b2_model,
                                                           reverse):
    label, cfg, params, _, port = b2_model
    c = cfg.sound.mel_dim * cfg.decoder.num_squeeze
    x, mask = ragged(np.random.default_rng(40), 2, 16, c, [16, 9])
    z_ref, ld_ref = jd.AffineCoupling(with_backend(cfg, 'flax')).apply(
        {'params': params['decoder']['flow_1']['coupling']},
        jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
    module = (port.layer_Dict['Decoder'].layer_Dict['Flows'][1].layers[2])
    with torch.no_grad():
        z, ld = module(t(x), t(mask), reverse)
    assert np.isfinite(np.asarray(z_ref)).all()
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if not reverse:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
def test_every_routes_decoder_matches_flax_at_the_b2_shapes(b2_model,
                                                            reverse):
    """The port's FlowDecoder under 'fused', 'modules' and 'mega' (each
    route's plain version on the CPU) against the flax decoder."""
    label, cfg, params, _, port = b2_model
    x, mask = ragged(np.random.default_rng(41), 2, 24, cfg.sound.mel_dim,
                     [24, 13])
    z_ref, ld_ref, _ = jd.FlowDecoder(with_backend(cfg, 'flax')).apply(
        {'params': params['decoder']}, jnp.asarray(x), jnp.asarray(mask),
        reverse=reverse)
    for route in ('fused', 'modules', 'mega'):
        decoder = port_model(with_backend(cfg, {
            'fused': 'fused', 'modules': 'flax', 'mega': 'mega'}[route]),
            params).layer_Dict['Decoder']
        assert decoder.mega_route == (route == 'mega')
        with torch.no_grad():
            z, ld, _ = decoder(t(x), t(mask), reverse=reverse)
        assert np.isfinite(np.asarray(z_ref)).all()
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref),
                                   err_msg=route, **Z_TOL)
        if not reverse:
            np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref),
                                       err_msg=route, **LD_TOL)


C200 = B2_SHAPES['c200']


def _weights(rng, c, n, k, ch, pitch_size=0):
    """``tests/test_torch_coupling.py``'s flow-step weights scaled to the
    fan-in of the full widths (at ch 192 its unit scales blow the stream up
    by many orders), so the comparisons are of numbers near 1."""
    w = _unit_weights(rng, c, n, k, ch, pitch_size)
    for key, fan in (('w_start', c // 2), ('w_in', k * ch), ('w_rs', ch),
                     ('w_end', ch)):
        w[key] = w[key] * np.float32(np.sqrt(16 / fan))
    return w


@pytest.mark.parametrize('reverse', [False, True])
def test_the_flow_step_matches_pallas_at_c200(reverse):
    """flow_step_reference against the JAX package's fused_flow_step in
    interpret mode at C = 200 (100-bin mels), B = 1, T_f = 16, one step."""
    c, ch, n, k = C200
    rng = np.random.default_rng(50)
    x, mask = ragged(rng, 1, 16, c, [13])
    w = _weights(rng, c, n, k, ch)
    cond = (rng.standard_normal((n, 1, 2 * ch)) * .2).astype(np.float32)
    z_ref, ld_ref = fused_flow_step(
        jnp.asarray(x), jnp.asarray(mask),
        {key: jnp.asarray(v) for key, v in w.items()}, jnp.asarray(cond),
        reverse=reverse, interpret=True)
    z, ld = tc.flow_step_reference(
        t(x), t(mask), {key: t(v) for key, v in w.items()}, t(cond),
        reverse=reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if not reverse:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


def test_the_coupling_matches_pallas_at_c200_with_a_pitch_operand():
    """coupling_reference against fused_coupling in interpret mode at
    C = 200 with GR's pitch operand (num_squeeze 2 wide)."""
    c, ch, n, k = C200
    rng = np.random.default_rng(51)
    x, mask = ragged(rng, 1, 16, c, [16])
    w = _weights(rng, c, n, k, ch, pitch_size=2)
    own = {key: w[key] for key in (*tc.COUPLING_WEIGHT_KEYS, 'w_pitch')}
    cond = (rng.standard_normal((n, 1, 2 * ch)) * .2).astype(np.float32)
    pitch = rng.standard_normal((1, 16, 2)).astype(np.float32)
    z_ref, ld_ref = fused_coupling(
        jnp.asarray(x[..., :c // 2]), jnp.asarray(x[..., c // 2:]),
        jnp.asarray(mask), {key: jnp.asarray(v) for key, v in own.items()},
        jnp.asarray(cond), jnp.asarray(pitch), interpret=True)
    z, ld = tc.coupling_reference(
        t(x[..., :c // 2]), t(x[..., c // 2:]), t(mask),
        {key: t(v) for key, v in own.items()}, t(cond), t(pitch))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


def test_the_bf16_flow_step_matches_pallas_at_c200():
    """At bfloat16 the port's flow step is no further from the JAX
    package's bf16 kernel (interpret mode) than twice that kernel's own
    distance from its f32 result."""
    c, ch, n, k = C200
    rng = np.random.default_rng(52)
    x, mask = ragged(rng, 1, 16, c, [16])
    w = _weights(rng, c, n, k, ch)
    cond = (rng.standard_normal((n, 1, 2 * ch)) * .2).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    jw = {key: jnp.asarray(v) for key, v in w.items()}
    j32, ld32 = fused_flow_step(jnp.asarray(x), jnp.asarray(mask), jw,
                                jnp.asarray(cond), interpret=True)
    j16, ld16 = fused_flow_step(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(mask), jw, jnp.asarray(cond),
                                interpret=True)
    z, ld = tc.flow_step_reference(
        t(x).to(torch.bfloat16), t(mask),
        {key: t(v) for key, v in w.items()}, t(cond))
    assert z.dtype == torch.bfloat16
    assert_bf16_close(z.float().numpy(),
                      np.asarray(j16.astype(jnp.float32)), np.asarray(j32),
                      'z')
    assert_bf16_close(ld.numpy(), np.asarray(ld16), np.asarray(ld32),
                      'logdet')
