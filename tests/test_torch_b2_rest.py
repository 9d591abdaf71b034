"""Every flow kernel (#2 ``coupling``, #3 ``flow_step``, #4 ``flow_stack``,
#5 and #6 ``flow_stack_train``) at every flow width C a multiple of 4 up
to 256 (ROADMAP B.2's rest, part 1), on the CPU:

* the envelope over a ``hypothesis`` sweep: every shape fits every body's
  block at both dtypes with a pitch operand 0, 1 or 2 wide (the ring
  body's tile owns 32 to 48 frames, within its 64 rows), the train builds
  take it but for their two limits (ch's grain, the layers), and where
  PR 24's geometry fit its block the geometry is unchanged;
* this slice's builds (128-bin mels' C = 256, 100-bin mels at Num_Squeeze
  1, Vanilla and GR, C = 200 at 8 layers): macros, counters, geometry;
* the split of C = 100 into halves of 50 (C/2 = 2 mod 4), written as the
  kernels' index arithmetic in torch: the loads' widths and alignment, the
  ring body's column pairs, the float32 body's 4-deep start conv and its
  4-column epilogues, the bf16 backward's staged half chunks; each gives
  the unsplit result exactly;
* the port's plain versions against the JAX package at C/2 = 2 mod 4 (C =
  12 and C = 100 at Num_Squeeze 1, a tiny WaveNet): the decoder under
  every route against flax, the flow step, coupling and stack against the
  Pallas kernels in interpret mode (GR's pitch operand 1 wide at C = 100,
  and at bf16), and ``flow_stack_train_reference`` against the JAX twin
  and the Pallas pair at dropout 0 and 0.05 (z, the logdet, every
  gradient).

Tolerances: ``tests/test_torch_coupling.py``'s at f32 (z rtol 3e-5 / atol
3e-6, logdet rtol 3e-5 / atol 1e-4), ``tests/test_torch_coupling_grad.py``'s
for the train stack (z 2e-5, logdet 2e-5 / 2e-4, gradients 1e-4), the bf16
bar of ``tests/torch_port_helpers.py``; the index emulations exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from glow_tts_tpu.models import decoder as jd
from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu.ops.coupling import (fused_coupling, fused_flow_stack,
                                       fused_flow_step)
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.ops import coupling_grad as tg
from glow_tts_tpu_torch.weights import reference_to_params
from tests.helpers import tiny_config
from tests.test_torch_b2_shapes import ENVELOPE_SHAPES
from tests.test_torch_b2_train import SEED, _jnp, _leaf, _problem
from tests.test_torch_coupling import _weights
from tests.torch_port_helpers import (assert_bf16_close, port_config,
                                      port_model, ragged, t, with_backend)

Z_TOL = dict(rtol=3e-5, atol=3e-6)
LD_TOL = dict(rtol=3e-5, atol=1e-4)
TRAIN_Z_TOL = dict(rtol=2e-5, atol=2e-5)
TRAIN_LD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# this slice's builds, as chip_smoke.py::B2_SHAPES names them: (shape, the
# pitch operand's width), their launch counts' names after '<what>_' and
# their macros
SLICE_BUILDS = {
    'c256': ((256, 192, 4, 5), 0, 'c256', ('GLOW_CHANNELS=256',)),
    'c100': ((100, 192, 4, 5), 0, 'c100', ('GLOW_CHANNELS=100',)),
    'c100_pitch': ((100, 192, 4, 5), 1, 'c100_pitch1',
                   ('GLOW_PITCH', 'GLOW_CHANNELS=100',
                    'GLOW_PITCH_SIZE=1')),
    'c200_l8': ((200, 192, 8, 5), 0, 'c200_ch192_l8_k5',
                ('GLOW_CHANNELS=200', 'GLOW_LAYERS=8'))}
# the tiny decoders held against the JAX package: C = 12 and C = 100 at
# Num_Squeeze 1 (C/2 = 6 and 50, both 2 mod 4), tiny_config's WaveNet
TINY = {'c12': (12, 16, 2, 5), 'c100': (100, 16, 2, 5)}


# --- the envelope -----------------------------------------------------------

def _pr24_geometry(shape, bf16, pitch, train):
    """The block PR 24's builds had at ``shape``: the ring body's tile
    always 64 − 2·halo frames (at most 48), #5 always with its saving
    stage (the pitch stage's rows the 64 of a ring tile, as flow_ring.cuh
    compiled them)."""
    c, ch, n, k = shape
    halo = shape.halo
    if bf16 and not train:
        tt = min(48, 64 - 2 * halo)
        smem, static, rows = tc.ring_smem_bytes(c, n, k, tt), 8 * c + 128, 64
        ch_pad = 192
    else:
        tt, ch_pad = 32, tc.body_width(ch)
        smem = tc.f32_smem_bytes(c, ch_pad, n, k, tt) + (
            4 * tt * (2 * ch_pad + 4) if train else 0)
        static, rows = 128, tt + 2 * halo
    base = smem + 4 * (2 * tc.MAX_BATCH + 1) + static + 4 * pitch * rows
    w_stage = 4 * pitch * n * 2 * ch_pad
    staged = int(bool(pitch) and base + w_stage <= tc.BLOCK_BYTES)
    return {'time_tile': tt, 'smem_bytes': smem, 'stage_w_pitch': staged,
            'block_bytes': base + w_stage * staged}


@settings(max_examples=80, deadline=None)
@given(ENVELOPE_SHAPES)
def test_every_shape_of_the_wider_envelope_fits_every_body(shape):
    """C a multiple of 4 from 8 to 256: no budget refuses a shape at either
    dtype with a pitch operand 0, 1 or 2 wide (where it divides C); the
    ring body's tile owns 32 to 48 frames within 64 rows; the train
    builds take every shape whose ch is a multiple of 4 (f32) or 8 (bf16),
    at most 24 layers; and every geometry whose PR 24 block fit is PR
    24's."""
    assert tc.envelope_error(shape) is None
    for bf16 in (False, True):
        for pitch in (0, 1, 2):
            if shape.channels % (pitch or 1):
                continue
            assert tc.budget_error(shape, bf16, pitch) is None
            for train in (False, True):
                g = tc.geometry(shape, bf16, pitch, train)
                assert g['block_bytes'] <= tc.BLOCK_BYTES
                old = _pr24_geometry(shape, bf16, pitch, train)
                if old['block_bytes'] <= tc.BLOCK_BYTES:
                    assert {key: g[key] for key in old} == old, (bf16, pitch,
                                                                train)
            tt = tc.geometry(shape, True, pitch)['time_tile']
            assert 32 <= tt <= 48 and tt + 2 * shape.halo <= 64
            grain = 8 if bf16 else 4
            assert (tc.train_error(shape, bf16, pitch) is None) == (
                shape.ch % grain == 0 and shape.n_layers <= 24)


@pytest.mark.parametrize('label', list(SLICE_BUILDS))
def test_this_slices_builds_are_taken_and_name_their_counters(label):
    """Each of this slice's builds passes check_envelope and
    check_train_shape at both dtypes, with its macros and its counters'
    names."""
    shape, ps, suffix, macros = SLICE_BUILDS[label]
    shape = tc.FlowShape(*shape)
    for bf16 in (False, True):
        assert tc.check_envelope('flow_step', shape, ps, bf16) == shape
        assert tc.check_train_shape('flow_stack_train', shape.channels,
                                    (shape.n_layers, shape.kernel_size,
                                     shape.ch, 2 * shape.ch), ps,
                                    bf16) == shape
        assert tc.build_defines(shape, ps, bf16) == macros + (
            ('GLOW_BF16',) if bf16 else ())
        assert tc.count_suffix(shape, ps, bf16) == (
            f'{"bf16_" if bf16 else ""}{suffix}_launches')


def test_the_ring_owns_40_frames_at_c256_and_32_with_a_pitch_operand():
    """At C = 256 the ring body's block needs 244,676 bytes at 48 owned
    frames: 40 fit (232,388 bytes, 60 to spare), and 32 with a pitch
    operand (its 64 rows of pitch push 40 over); every width up to 212 keeps
    48, 216 to 256 take 40; the float32 body keeps 32 everywhere."""
    assert _pr24_geometry(tc.FlowShape(256), True, 0,
                          False)['block_bytes'] == 244676
    g = tc.geometry(256, True)
    assert (g['time_tile'], g['block_bytes']) == (40, 232388)
    assert tc.geometry(256, True, 2)['time_tile'] == 32
    assert tc.geometry(256, True, 1)['time_tile'] == 32
    for c in range(8, 257, 4):
        assert tc.ring_time_tile(c, 4, 5) == (48 if c <= 212 else 40), c
        assert tc.geometry(c)['time_tile'] == 32
    # 13 tiles of a 512-frame sample where 48 frames would take 11
    assert -(-512 // 40) == 13 and -(-512 // 48) == 11


def test_c200_at_8_layers_trains_without_its_saving_stage():
    """(200, 192, 8, 5): #5's block with its saving stage is 242,692 bytes;
    without it the block fits, so #5 stores the gate halves from its
    registers (save_stage 0, the buffers alone in smem_bytes); C = 200 at 4
    layers keeps the stage, and so does every shipped build."""
    shape = tc.FlowShape(200, 192, 8, 5)
    assert _pr24_geometry(shape, False, 0, True)['block_bytes'] == 242692
    for bf16 in (False, True):
        g = tc.geometry(shape, bf16, train=True)
        assert g['save_stage'] == 0
        assert g['smem_bytes'] == tc.geometry(shape)['smem_bytes']
        assert g['block_bytes'] <= tc.BLOCK_BYTES
    for shape in (tc.FlowShape(200), *tc.SHIPPED_SHAPES):
        assert tc.geometry(shape, train=True)['save_stage'] == 1


# --- the split at C/2 = 50, as the kernels index it -------------------------

def _ring_vec(c):
    """flow_ring.cuh::RingShape's VEC (bf16 elements of a half's load) and
    XVEC (of a whole row's)."""
    c2 = c // 2
    return (8 if c2 % 8 == 0 else 4 if c2 % 4 == 0 else 2,
            8 if c % 8 == 0 else 4)


def _f32_half_vec(c):
    """flow_common.cuh::Shape::HV: floats of a half's load."""
    return 4 if (c // 2) % 4 == 0 else 2


@pytest.mark.parametrize('c', [100, 12, 200, 160, 256, 36])
def test_the_loads_cover_each_half_exactly_and_aligned(c):
    """Each body's loads of a [B, T, C] tensor's rows, by the kernels' index
    arithmetic (chunk i of row r at column V (i mod C2/V), x_b's at C2 +
    that; a whole row's XVEC at a time up to C): every element of each
    half is read once, no chunk straddles C/2, and every chunk's byte
    address is a multiple of its width (16, 8 or 4: half_load_bytes) on a
    tensor 256-byte aligned, x_b's half included (8 bytes into a 16-byte
    chunk at C = 100 f32)."""
    c2, rows = c // 2, 5
    vec, xvec = _ring_vec(c)
    for esize, v in ((2, vec), (4, _f32_half_vec(c))):
        assert v * esize == tc.half_load_bytes(c, esize == 2)
        assert c2 % v == 0
        seen = torch.zeros(rows, c, dtype=torch.int64)
        for half in (0, c2):
            for i in range(rows * (c2 // v)):
                r, col = i // (c2 // v), half + v * (i % (c2 // v))
                assert ((r * c + col) * esize) % (v * esize) == 0
                assert (col < c2) == (col + v - 1 < c2)
                seen[r, col:col + v] += 1
        assert torch.equal(seen, torch.ones_like(seen))
    # a whole row (the ring's mixing input): XVEC a load, chunks below C
    kmix = -(-c // 64) * 64
    seen = torch.zeros(rows, c, dtype=torch.int64)
    for i in range(rows * (kmix // xvec)):
        r, col = i // (kmix // xvec), xvec * (i % (kmix // xvec))
        if col < c:
            assert col + xvec <= c and ((r * c + col) * 2) % (2 * xvec) == 0
            seen[r, col:col + xvec] += 1
    assert torch.equal(seen, torch.ones_like(seen))


@pytest.mark.parametrize('c', [100, 12, 200, 256, 80])
def test_the_ring_epilogues_column_pairs_cover_each_output_half(c):
    """A thread's cells of a 1x1 conv's output half (the mixing's x_a and
    x_b, the end conv's mean and logs) are the column pairs col0 + k, col0
    in {0, 2, 4, 6}, k = 96 j + 8 n (ring_cols); ring_past drops the pairs
    at or past C/2.  The kept pairs tile [0, C/2) exactly and none
    straddles it (C/2 even), so each half's values land in their own
    columns, at C = 100 as at 200."""
    c2 = c // 2
    nws = -(-c2 // 96)
    cover = torch.zeros(2 * 96 * nws, dtype=torch.int64)
    for col0 in (0, 2, 4, 6):
        for j in range(nws):
            for n in range(12):
                k = 96 * j + 8 * n
                past = (k >= c2) if c2 % 8 == 0 else (col0 + k >= c2)
                if not past:
                    assert col0 + k + 1 < c2
                    cover[col0 + k:col0 + k + 2] += 1
    assert torch.equal(cover[:c2], torch.ones(c2, dtype=torch.int64))
    assert not cover[c2:].any()


def test_the_start_conv_takes_c2_50_deep_without_reading_x_b():
    """The float32 body's start conv (flow_common.cuh::block_gemm over x's
    rows [x_a | x_b], C = 100 floats apart) at K = C/2 = 50: 12 whole
    4-deep steps, then the 2-deep tail (KTAIL = C2 mod 4) one depth at a
    time.  On integer-valued operands (every sum exact in float64) it is
    x_a . w_start exactly; whole 4-deep steps over 52 would add x_b's
    first two columns times the rows past w_start."""
    gen = torch.Generator().manual_seed(5)
    c, ch = 100, 64
    c2 = c // 2
    xs = torch.randint(-4, 5, (8, c), generator=gen).double()
    w = torch.randint(-4, 5, (c2 + 2, ch), generator=gen).double()
    tail = c2 % 4
    acc = torch.zeros(8, ch, dtype=torch.float64)
    for k0 in range(0, c2 - tail, 4):
        for kk in range(4):
            acc += xs[:, k0 + kk, None] * w[k0 + kk]
    for kk in range(tail):
        k = c2 - tail + kk
        acc += xs[:, k, None] * w[k]
    assert torch.equal(acc, xs[:, :c2] @ w[:c2])
    whole = sum(xs[:, k, None] * w[k] for k in range(c2 + 2))
    assert not torch.equal(whole, acc)


def test_the_float32_epilogues_4_column_groups_straddle_c2_harmlessly():
    """The float32 body's end conv and mixing write 4-column groups of a
    C-wide row (flow_common.cuh::block_gemm's epilogue), and at C = 100
    group 12 holds mean's columns 48, 49 and logs' 0, 1; the affine and the
    saved logs read each half by its absolute column (the saved logs two
    at a time from gs + C2, Shape::HV = 2): the groups give the unsplit
    [mean, logs] exactly, and z_b, the logdet and the saved logs are the
    unsplit computation's."""
    gen = torch.Generator().manual_seed(6)
    c, tt, ch = 100, 32, 64
    c2 = c // 2
    skip = torch.randn(tt, ch, generator=gen, dtype=torch.float64)
    w_end = torch.randn(ch, c, generator=gen, dtype=torch.float64)
    gs = torch.zeros(tt, c, dtype=torch.float64)
    for q in range(c // 4):
        gs[:, 4 * q:4 * q + 4] = skip @ w_end[:, 4 * q:4 * q + 4]
    want = skip @ w_end
    assert torch.equal(gs, want)
    assert 4 * 12 < c2 < 4 * 13                  # the straddling group
    hv = _f32_half_vec(c)
    logs = torch.zeros(tt, c2, dtype=torch.float64)
    for i in range(tt * (c2 // hv)):
        r, col = i // (c2 // hv), hv * (i % (c2 // hv))
        assert (r * c + c2 + col) % hv == 0      # float2 reads of gs + C2
        logs[r, col:col + hv] = gs[r, c2 + col:c2 + col + hv]
    mean, ref_logs = want.chunk(2, dim=-1)
    assert torch.equal(logs, ref_logs) and torch.equal(gs[:, :c2], mean)


@pytest.mark.parametrize('end', [100, 50])
def test_the_bf16_backward_stages_c100_rows_as_exact_half_chunks(end):
    """flow_train_bwd.cu's bf16 build at C = 100 (kHalfChunks): a row of C
    bf16 elements is 200 bytes, so each 16-byte chunk of a staged slice
    (elements k .. k + 7, k a multiple of 8) goes as two 8-byte copies,
    half h where k + 4 h < end (the depth kseg or the width N), else zeros.
    Staged rows are the row below ``end`` and zeros past it (end = 100: the
    C-deep products); at end = C/2 = 50 the half at 48 also reads columns
    50 and 51 (x_b's, of yd), which enter only rows of the weight gradient
    past its depth, never stored: the stored rows are the unsplit
    product's exactly."""
    gen = torch.Generator().manual_seed(7)
    c, frames, width = 100, 6, 8
    row = torch.randint(-3, 4, (frames, c), generator=gen).double()
    slices = -(-end // 64)
    staged = torch.zeros(frames, 64 * slices, dtype=torch.float64)
    for k in range(0, 64 * slices, 8):
        for h in range(2):
            first = k + 4 * h
            assert (first * 2) % 8 == 0 and (c * 2) % 8 == 0   # aligned
            if first < end:
                staged[:, first:first + 4] = row[:, first:first + 4]
    assert torch.equal(staged[:, :end], row[:, :end])
    spill = -(-end // 4) * 4
    assert not staged[:, spill:].any()
    assert torch.equal(staged[:, end:spill], row[:, end:spill])
    g = torch.randint(-3, 4, (frames, width), generator=gen).double()
    dw = staged.T @ g                            # [depth, N]: rows kd
    assert torch.equal(dw[:end], row[:, :end].T @ g)


# --- the JAX package at C/2 = 2 mod 4 ---------------------------------------

def _tiny_config(label):
    c, ch, n, k = TINY[label]
    sound = {'Mel_Dim': c, 'Spectrogram_Dim': 65, 'Frame_Length': 64,
             'Frame_Shift': 16, 'Sample_Rate': 1600}
    decoder = {'Stack': 2, 'Num_Squeeze': 1, 'Num_Split': 4,
               'Affine_Coupling': {'Calc_Channels': ch, 'WaveNet': {
                   'Num_Layers': n, 'Kernel_Size': k,
                   'Dropout_Rate': 0.05}}}
    return tiny_config(Sound=sound, Decoder=decoder)


@pytest.fixture(scope='module', params=list(TINY))
def tiny_model(request):
    """(label, JAX config, JAX params, port model) of a tiny decoder at
    C/2 = 2 mod 4: the port's seeded weights (a nonzero end conv) through
    the weight bridge."""
    from glow_tts_tpu_torch import random_state_dict
    cfg = _tiny_config(request.param)
    pcfg = port_config(cfg)
    assert tuple(tc.config_shape(pcfg)) == TINY[request.param]
    sd = {key: value.detach().numpy().copy()
          for key, value in random_state_dict(pcfg, 29).items()}
    params = reference_to_params(sd, pcfg)
    return request.param, cfg, params, port_model(cfg, params)


@pytest.mark.parametrize('reverse', [False, True])
def test_every_routes_decoder_matches_flax_at_c2_2_mod_4(tiny_model,
                                                         reverse):
    """The port's FlowDecoder under 'fused', 'modules' and 'mega' (each
    route's plain version) against the flax decoder at C = 12 and 100,
    Num_Squeeze 1: z and the logdet."""
    label, cfg, params, _ = tiny_model
    x, mask = ragged(np.random.default_rng(43), 2, 24, cfg.sound.mel_dim,
                     [24, 13])
    z_ref, ld_ref, _ = jd.FlowDecoder(with_backend(cfg, 'flax')).apply(
        {'params': params['decoder']}, jnp.asarray(x), jnp.asarray(mask),
        reverse=reverse)
    assert np.isfinite(np.asarray(z_ref)).all()
    for route in ('fused', 'modules', 'mega'):
        decoder = port_model(with_backend(cfg, {
            'fused': 'fused', 'modules': 'flax', 'mega': 'mega'}[route]),
            params).layer_Dict['Decoder']
        with torch.no_grad():
            z, ld, _ = decoder(t(x), t(mask), reverse=reverse)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref),
                                   err_msg=route, **Z_TOL)
        if not reverse:
            np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref),
                                       err_msg=route, **LD_TOL)


def _pallas_problem(label, seed, pitch_size=0, steps=None):
    """x, mask (B = 2, T_f = 16, one sample ragged), the weights of one
    flow step (or ``steps`` stacked), cond and the pitch operand (or
    None) of the tiny decoder ``label``."""
    c, ch, n, k = TINY[label]
    rng = np.random.default_rng(seed)
    x, mask = ragged(rng, 2, 16, c, [16, 11])
    per = [_weights(rng, c, n, k, ch, pitch_size)
           for _ in range(steps or 1)]
    w = per[0] if steps is None else {
        key: np.stack([p[key] for p in per]) for key in per[0]}
    cond = (rng.standard_normal(((steps,) if steps else ()) + (n, 2, 2 * ch))
            * .2).astype(np.float32)
    pitch = (rng.random((2, 16, pitch_size)).astype(np.float32) * mask
             if pitch_size else None)
    return x, mask, w, cond, pitch


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('label,pitch_size', [('c12', 0), ('c100', 1)])
def test_the_flow_step_matches_pallas_at_c2_2_mod_4(label, pitch_size,
                                                    reverse):
    """flow_step_reference against fused_flow_step in interpret mode at C =
    12 (Vanilla) and C = 100 with GR's pitch operand 1 wide."""
    x, mask, w, cond, pitch = _pallas_problem(label, 60, pitch_size)
    z_ref, ld_ref = fused_flow_step(
        jnp.asarray(x), jnp.asarray(mask), _jnp(w), jnp.asarray(cond),
        _jnp(pitch), reverse=reverse, interpret=True)
    z, ld = tc.flow_step_reference(
        t(x), t(mask), {key: t(v) for key, v in w.items()}, t(cond),
        reverse, None if pitch is None else t(pitch))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if not reverse:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('label,pitch_size', [('c12', 0), ('c100', 1)])
def test_the_coupling_matches_pallas_at_c2_2_mod_4(label, pitch_size):
    """coupling_reference against fused_coupling in interpret mode on the
    halves of C = 12 and of C = 100 (with the pitch operand 1 wide)."""
    x, mask, w, cond, pitch = _pallas_problem(label, 61, pitch_size)
    c2 = x.shape[-1] // 2
    own = {key: w[key] for key in (*tc.COUPLING_WEIGHT_KEYS,
                                   *(('w_pitch',) if pitch_size else ()))}
    z_ref, ld_ref = fused_coupling(
        jnp.asarray(x[..., :c2]), jnp.asarray(x[..., c2:]),
        jnp.asarray(mask), _jnp(own), jnp.asarray(cond), _jnp(pitch),
        interpret=True)
    z, ld = tc.coupling_reference(
        t(x[..., :c2]), t(x[..., c2:]), t(mask),
        {key: t(v) for key, v in own.items()}, t(cond),
        None if pitch is None else t(pitch))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
def test_the_flow_stack_matches_pallas_at_c12(reverse):
    """flow_stack_reference against fused_flow_stack in interpret mode at
    C = 12, two flow steps."""
    x, mask, w, cond, _ = _pallas_problem('c12', 62, steps=2)
    z_ref, ld_ref = fused_flow_stack(
        jnp.asarray(x), jnp.asarray(mask), _jnp(w), jnp.asarray(cond),
        reverse=reverse, interpret=True)
    z, ld = tc.flow_stack_reference(
        t(x), t(mask), {key: t(v) for key, v in w.items()}, t(cond),
        reverse=reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    if not reverse:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('label,pitch_size', [('c12', 0), ('c100', 1)])
def test_the_bf16_flow_step_matches_pallas_at_c2_2_mod_4(label, pitch_size):
    """At bfloat16 the port's flow step is no further from the JAX
    package's bf16 kernel (interpret mode) than twice that kernel's own
    distance from its f32 result, at C = 12 and at C = 100 with the pitch
    operand."""
    x, mask, w, cond, pitch = _pallas_problem(label, 63, pitch_size)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    j32, ld32 = fused_flow_step(jnp.asarray(x), jnp.asarray(mask), _jnp(w),
                                jnp.asarray(cond), _jnp(pitch),
                                interpret=True)
    j16, ld16 = fused_flow_step(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(mask), _jnp(w),
                                jnp.asarray(cond), _jnp(pitch),
                                interpret=True)
    z, ld = tc.flow_step_reference(
        t(x).to(torch.bfloat16), t(mask),
        {key: t(v) for key, v in w.items()}, t(cond),
        pitch=None if pitch is None else t(pitch))
    assert z.dtype == torch.bfloat16
    assert_bf16_close(z.float().numpy(),
                      np.asarray(j16.astype(jnp.float32)), np.asarray(j32),
                      'z')
    assert_bf16_close(ld.numpy(), np.asarray(ld16), np.asarray(ld32),
                      'logdet')


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('label,pitch_size', [('c12', 0), ('c100', 1)])
def test_the_plain_train_stack_matches_jax_at_c2_2_mod_4(label, pitch_size,
                                                         rate):
    """z, the logdet and every gradient (weights, x, cond, pitch) of a loss
    through the port's flow_stack_train_reference against the JAX
    package's twin at C = 12 and C = 100 (GR's pitch operand 1 wide): the
    dropout masks are bit-equal, so dropout adds no tolerance."""
    w, x, mask, cond, pitch, zt = _problem(TINY[label], pitch_size, [9, 6],
                                           17 + pitch_size)
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
                               **TRAIN_Z_TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref),
                               **TRAIN_LD_TOL)
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


def test_the_plain_train_stack_matches_pallas_at_c100():
    """The JAX package's Pallas pair in interpret mode at C = 100 with the
    pitch operand 1 wide, dropout 0.05, against the port's plain version
    (what flow_stack_train computes on the CPU)."""
    w, x, mask, cond, pitch, _ = _problem(TINY['c100'], 1, [9, 6], 37)
    z_ref, ld_ref = JCG.fused_flow_stack_train(
        _jnp(x), _jnp(mask), _jnp(w), _jnp(cond), _jnp(pitch),
        seed=jnp.int32(SEED), dropout_rate=0.05, interpret=True)
    z, ld = tg.flow_stack_train(t(x), t(mask), {k: t(v) for k, v in w.items()},
                                t(cond), t(pitch), seed=SEED,
                                dropout_rate=0.05)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TRAIN_Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref),
                               **TRAIN_LD_TOL)
