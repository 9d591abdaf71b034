"""The host-side pieces and the shared-memory arithmetic of the bf16 train
kernels (#5 and #6 built with ``GLOW_BF16``), on the CPU:

* the backward's bfloat16 weights (``coupling_grad.backward_weights_bf16``)
  are ``tensor.to(torch.bfloat16)`` of the f32 weights, bit for bit, and
  JAX's ``astype(jnp.bfloat16)`` of the same arrays (the TPU kernel's cast
  of each dot's weight to ``dt``), at ``tests/helpers.py::tiny_config``
  size; the cotangent copies' shapes and dtype;
* the activation-gradient tiles' 128-byte swizzle (``ops/bf16_tiles.py``,
  the twin of ``csrc/bf16_mma.cuh``): staging undoes exactly, each 8-row
  group fills its own 1024 bytes, and every 16-deep step ``wgmma`` reads
  through an advanced descriptor is the tile's own;
* the lanes' ``ldmatrix`` addresses of the weight-gradient tile (``.trans``
  on frame-major slices) and of the forward's bf16 body give the exact
  products of each warp's tile through simulated ``mma.sync.m16n8k16``;
* the weight gradients' walk of 32-frame slices covers every valid frame
  of every sample once, inside its chunk.

Exact comparisons throughout: every value is a bfloat16 and every product
of two of them is exact in float32 (sums of 16 such in float64 are compared
as float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu_torch.ops import bf16_tiles
from glow_tts_tpu_torch.ops import coupling_grad as cg
from tests.helpers import tiny_config


def bf16_values(gen, *shape):
    """Seeded values that are exact in bfloat16."""
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


def test_backward_weights_bf16_round_as_jax():
    config = tiny_config()
    dec = config.decoder
    c = config.sound.mel_dim * dec.num_squeeze
    ch = dec.affine_coupling.calc_channels
    n, k = dec.affine_coupling.wavenet.num_layers, \
        dec.affine_coupling.wavenet.kernel_size
    gen = np.random.default_rng(1801)
    shapes = cg.weight_shapes(dec.stack, c, ch, n, k)
    weights = {key: torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32)) for key, shape in shapes.items()}
    got = cg.backward_weights_bf16(weights)
    assert tuple(got) == cg.PRODUCT_WEIGHT_KEYS
    for key, value in got.items():
        assert value.dtype == torch.bfloat16 and value.is_contiguous()
        assert value.shape == weights[key].shape
        assert torch.equal(value.view(torch.int16),
                           weights[key].to(torch.bfloat16).view(torch.int16))
        jax_bits = np.asarray(jnp.asarray(weights[key].numpy()).astype(
            jnp.bfloat16)).view(np.int16)
        assert np.array_equal(value.view(torch.int16).numpy(), jax_bits), key


def test_cotangent_copies_bf16_shapes():
    douts, drs, dpre = cg.cotangent_copies_bf16(24, 16, 32, 'cpu')
    assert [tuple(t.shape) for t in (douts, drs, dpre)] == [
        (24, 16), (24, 32), (24, 32)]
    assert all(t.dtype == torch.bfloat16 for t in (douts, drs, dpre))


@pytest.mark.parametrize('rows', [96, 128])
def test_sw128_staging_undoes_and_wgmma_reads_the_tile(rows):
    gen = np.random.default_rng(rows)
    tile = bf16_values(gen, rows, 64)
    offsets = bf16_tiles.sw128_offsets(rows)
    # a permutation of the tile's chunks, each 8-row group in its 1024 bytes
    assert sorted(offsets.flatten().tolist()) == list(range(0, rows * 128,
                                                            16))
    assert torch.equal(offsets // 1024,
                       (torch.arange(rows) // 8)[:, None].expand(rows, 8))
    image = bf16_tiles.stage_sw128(tile)
    assert torch.equal(bf16_tiles.unstage_sw128(image, rows), tile)
    for row0 in range(0, rows, 64):
        for k in range(4):
            got = bf16_tiles.wgmma_k_major_rows(image, row0, min(64, rows
                                                                 - row0), k)
            assert torch.equal(got, tile[row0:row0 + 64, 16 * k:16 * k + 16])


@pytest.mark.parametrize('warp', range(8))
def test_wgrad_tile_fragments_give_the_product(warp):
    """A slice of P (32 frames x 96 channels) and G (32 frames x 128
    columns) at the kernel's pitches: warp (wm, wn) = (warp / 4, warp % 4)
    reads its fragments with ldmatrix.trans and its 48 x 32 share of P^T . G
    comes out exact."""
    ldp, ldg = 104, 136
    gen = np.random.default_rng(1802 + warp)
    p_slice, g_slice = bf16_values(gen, 32, ldp), bf16_values(gen, 32, ldg)
    wm, wn = warp // 4, warp % 4
    a_off, b_off = bf16_tiles.wgrad_lane_rows(wm, wn, ldp, ldg)
    p_flat, g_flat = p_slice.flatten(), g_slice.flatten()
    out = torch.zeros((48, 32), dtype=torch.float64)
    for kk in (0, 16):
        for mt in range(3):
            a = bf16_tiles.ldmatrix_x4(
                p_flat, 2 * (a_off + kk * ldp + 16 * mt), trans=True)
            for np_ in range(2):
                b = bf16_tiles.ldmatrix_x4(
                    g_flat, 2 * (b_off + kk * ldg + 16 * np_), trans=True)
                for half in range(2):
                    part = bf16_tiles.mma_m16n8k16(a, b[:, 2 * half:
                                                        2 * half + 2])
                    nt = 2 * np_ + half
                    out[16 * mt:16 * mt + 16, 8 * nt:8 * nt + 8] += \
                        part.double()
    want = (p_slice[:, 48 * wm:48 * wm + 48].double().T
            @ g_slice[:, 32 * wn:32 * wn + 32].double())
    assert torch.equal(out, want)


@pytest.mark.parametrize('shift', [0, 1, 3])
def test_forward_fragments_read_shifted_rows(shift):
    """The forward's bf16 body: rows of CH + 8 = 200 bfloat16 (400 bytes),
    a 16 x 16 A block at any row (the k-tap conv's taps shift it by one row
    each) and depth 16 kb, read by ldmatrix.x4, times a 16 x 8 B block."""
    pitch = 200
    gen = np.random.default_rng(1810 + shift)
    h = bf16_values(gen, 40, pitch)
    w = bf16_values(gen, 16, 8)
    lane_at = bf16_tiles.forward_lane_rows(2 * pitch)
    # the ldmatrix rows of 8 lanes fall in 8 distinct 16-byte bank groups
    for i in range(4):
        banks = ((lane_at[8 * i:8 * i + 8] + 2 * pitch * shift) % 128) // 16
        assert len(set(banks.tolist())) == 8
    kb = 5
    start = 2 * (shift * pitch + 16 * kb)
    a = bf16_tiles.ldmatrix_x4(h.flatten(), start + lane_at)
    lanes = torch.arange(32)
    g, t = lanes // 4, lanes % 4
    b = torch.stack([torch.stack([w[2 * t + e, g] for e in range(2)], 1),
                     torch.stack([w[2 * t + 8 + e, g] for e in range(2)], 1)],
                    dim=1)
    got = bf16_tiles.mma_m16n8k16(a, b).double()
    want = (h[shift:shift + 16, 16 * kb:16 * kb + 16].double()
            @ w.double())
    assert torch.equal(got, want)


@pytest.mark.parametrize('spc', [1, 3, 32])
def test_wgrad_slices_cover_every_valid_frame_once(spc):
    lengths = [0, 1, 31, 32, 33, 512, 200, 64, 7] * 3 + [0]
    slices = bf16_tiles.wgrad_slices(lengths, spc)
    frames = [(b, frame + i) for _, b, frame in slices
              for i in range(bf16_tiles.WGRAD_SLICE)
              if frame + i < lengths[b]]
    want = [(b, f) for b, length in enumerate(lengths) for f in range(length)]
    assert sorted(frames) == want and len(set(frames)) == len(want)
    assert all(chunk * spc <= b < (chunk + 1) * spc
               for chunk, b, _ in slices)
    assert len(slices) == sum(-(-length // 32) for length in lengths)
