"""The layouts of the bfloat16 flow step's ring body (``csrc/flow_ring.cuh``,
the ``GLOW_BF16`` builds of ``flow_step.cu``, ``flow_stack.cu`` and
``coupling.cu``) that only the card runs, held on the CPU through their plain
twins (``glow_tts_tpu_torch/ops/bf16_tiles.py``) at the built widths:

* the packing (``ops/coupling.py::ring_layout_bf16``, ``ring_weights``): the
  kernel's shapes, a permutation of the weights and their zero padding (the
  WaveNet products' the same values as ``tensor_core_layout_bf16``'s), in
  the order the ring stages the slices;
* each staged slice read back through ``wgmma``'s descriptor as every
  warpgroup's B operand, in the 64-byte swizzle;
* the A fragments each lane's ``ldmatrix`` gives, the k-tap conv's tap one
  row further each, and one ``wgmma`` of a slice against the plain product;
* the accumulator's cells, and the gate's (tanh, sigmoid) pair of each
  channel in one thread;
* the coupling's program and weights: the flow step's without the mixing,
  the ring slices its wrapper reads, and those the ``'modules'`` route
  hands it.
"""

import numpy as np
import pytest
import torch

from glow_tts_tpu_torch.ops import bf16_tiles as bt
from glow_tts_tpu_torch.ops import coupling as tc

CH, K, N = 192, 5, 4                 # the shipped WaveNet
SK = tc.RING_DEPTH                   # a ring slice's depth
HP = CH + 8                          # RingShape::HP, h's pitch in bf16
H_ROWS = 64 + 2 * (K - 1) // 2 * 2   # tile rows -2 .. 65
# each product: its weight, the warpgroups' 96-column blocks, a layer's
# (the mixing's and the end conv's 2 where C/2 is over 96: ``tc.ring_half``)
PRODUCTS = {'mixing': ('mix_t', 1), 'start conv': ('w_start', 1),
            'k-tap conv': ('w_in', 2), 'res/skip conv': ('w_rs', 2),
            'end conv': ('w_end', 1)}
# the builds' shapes: the shipped two (under their channel counts' ids) and
# those of ROADMAP B.2 (100-bin mels, tiny_config's decoder, another
# WaveNet), whose WaveNet the ring pads to 192
SHAPES = [pytest.param(tc.FlowShape(160), id='160'),
          pytest.param(tc.FlowShape(80), id='80'),
          pytest.param(tc.FlowShape(200), id='c200'),
          pytest.param(tc.FlowShape(16, 16, 2, 5), id='c16_ch16_l2_k5'),
          pytest.param(tc.FlowShape(160, 128, 16, 3),
                       id='c160_ch128_l16_k3')]


def _weights(shape, seed=0):
    c, ch, n, k = tc.as_shape(shape)
    rng = np.random.default_rng(seed)

    def randn(*dims):
        return torch.from_numpy(
            rng.standard_normal(dims).astype(np.float32) * 0.1)
    w_rs = randn(n, ch, 2 * ch)
    w_rs[-1, :, :ch] = 0.0                 # the last layer's res half
    return {'mix_t': randn(c, c), 'w_start': randn(c // 2, ch),
            'w_in': randn(n, k, ch, 2 * ch), 'w_rs': w_rs,
            'w_end': randn(ch, c)}


def _nw(shape, key):
    """A warpgroup's 96-column blocks of ``key``'s product at ``shape``."""
    if key in ('mix_t', 'w_end'):
        return tc.ring_half(tc.as_shape(shape).channels) // 96
    return PRODUCTS[next(name for name, (k, _) in PRODUCTS.items()
                         if k == key)][1]


def _product(w, key):
    """One layer's ``[K, N]`` weight of a product as the ring packs it: the
    WaveNet at the ring body's width (192, zero-padded)."""
    if key in ('w_start', 'w_in', 'w_rs', 'w_end'):
        w = {key: tc.padded_wavenet(key, w[key], tc.RING_HALF_BIG)}
    if key == 'w_in':
        return tc.interleave_gate(w['w_in'])[0]
    return w[key][0] if key == 'w_rs' else w[key]


def _packed(w, key):
    name = tc.RING_KEYS[key]
    packed = tc.ring_weights({key: w[key]})[name]
    return packed[0] if key in ('w_in', 'w_rs') else packed


@pytest.mark.parametrize('c', SHAPES)
def test_ring_weights_take_the_kernels_shapes(c):
    w = _weights(c)
    packed = tc.ring_weights(w)
    want = tc.ring_shapes(c.channels, c.n_layers, c.kernel_size, c.ch)
    assert set(packed) == set(tc.RING_KEYS.values())
    for name, tensor in packed.items():
        assert tuple(tensor.shape) == want[name], name
        assert tensor.dtype == torch.bfloat16 and tensor.is_contiguous()
    # a stack of flow steps packs step by step
    stacked = tc.ring_weights({key: torch.stack([w[key], 2 * w[key]])
                               for key in w})
    for name, tensor in stacked.items():
        assert torch.equal(tensor[0], packed[name])


@pytest.mark.parametrize('product', PRODUCTS)
@pytest.mark.parametrize('c', SHAPES)
def test_ring_layout_is_a_permutation_of_the_weights(c, product):
    key, _ = PRODUCTS[product]
    w = _weights(c, 1)
    plain = _product(w, key).to(torch.bfloat16).float()
    packed = _packed(w, key).float()
    zeros = packed.numel() - plain.numel()
    want = torch.cat([plain.flatten(), torch.zeros(zeros)])
    assert torch.equal(packed.flatten().sort().values, want.sort().values)
    if key in ('w_in', 'w_rs') and c.ch == CH:
        # no padding: the values of the mma.sync layout, reordered
        layout = tc.tensor_core_weights(w['w_in'], w['w_rs'],
                                        torch.bfloat16)[tc.TC_KEYS[key]][0]
        assert zeros == 0
        assert torch.equal(packed.flatten().sort().values,
                           layout.float().flatten().sort().values)


@pytest.mark.parametrize('product', PRODUCTS)
@pytest.mark.parametrize('c', SHAPES)
def test_staged_slices_read_back_as_each_warpgroups_operand(c, product):
    key, _ = PRODUCTS[product]
    nw = _nw(c, key)
    w = _weights(c, 2)
    plain = _product(w, key).to(torch.bfloat16)
    depth, n = plain.shape
    half = n // 2
    packed = _packed(w, key)
    assert packed.shape[0] == -(-depth // SK)
    for s in range(packed.shape[0]):
        image = packed[s].flatten()
        for wg in (0, 1):
            for j in range(nw):
                for kk in range(SK // 16):
                    got = bt.ring_slice_operand(image, wg, nw, j, kk)
                    want = torch.zeros((96, 16), dtype=torch.bfloat16)
                    cols = 96 * j + torch.arange(96)
                    ks = SK * s + 16 * kk + torch.arange(16)
                    ok = cols < half
                    kin = ks < depth
                    block = plain[ks[kin]][:, wg * half + cols[ok]].T
                    want[ok.nonzero()[:, 0][:, None],
                         kin.nonzero()[:, 0][None, :]] = block
                    assert torch.equal(got, want), (s, wg, j, kk)


@pytest.mark.parametrize('mixing', [True, False],
                         ids=['flow step', 'coupling'])
@pytest.mark.parametrize('c', SHAPES)
@pytest.mark.parametrize('reverse', [False, True])
def test_the_ring_stages_every_slice_once_in_the_bodys_order(c, reverse,
                                                            mixing):
    """``ring_slice``'s program (``bt.ring_program``) against the products'
    slices: each once, mixing first (last on the inverse pass), then the
    start conv, each layer's k-tap and res/skip convs, the end conv; the
    coupling's (no ``mixing``) the same without the mixing's slices."""
    shapes = tc.ring_shapes(c.channels, c.n_layers, c.kernel_size, c.ch)
    program = bt.ring_program(c.channels, reverse, c.n_layers,
                              c.kernel_size, tc.RING_HALF_BIG, mixing=mixing)
    slices = {'mix_ring': shapes['mix_ring'][0],
              'start_ring': shapes['start_ring'][0],
              'end_ring': shapes['end_ring'][0]}
    want = [('start_ring', None, s) for s in range(slices['start_ring'])]
    for layer in range(c.n_layers):
        want += [('in_ring', layer, s) for s in range(shapes['in_ring'][1])]
        want += [('rs_ring', layer, s) for s in range(shapes['rs_ring'][1])]
    want += [('end_ring', None, s) for s in range(slices['end_ring'])]
    mix = [('mix_ring', None, s) for s in range(slices['mix_ring'])
           if mixing]
    want = want + mix if reverse else mix + want
    assert program == want
    assert len(program) == len(set(program))


@pytest.mark.parametrize('tap', range(K))
def test_a_fragments_shift_a_row_a_tap(tap):
    rng = np.random.default_rng(3 + tap)
    h = torch.from_numpy(rng.standard_normal((H_ROWS, HP)).astype(
        np.float32)).to(torch.bfloat16)
    flat = h.flatten()
    w_in = tc.interleave_gate(_weights(160, 4)['w_in'])[0].to(torch.bfloat16)
    packed = _packed({'w_in': _weights(160, 4)['w_in']}, 'w_in')
    for cb in range(CH // SK):
        s = CH // SK * tap + cb
        for kk in range(SK // 16):
            c0 = SK * cb + 16 * kk
            lanes = bt.ring_lane_rows(2 * HP, tap) + 2 * c0
            a = torch.empty((64, 16), dtype=torch.float64)
            for warp in range(4):
                frag = bt.ldmatrix_x4(flat, lanes[warp])
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for i, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                                (g, 2 * t + 8),
                                                (g + 8, 2 * t + 8))):
                        row = 16 * warp + r
                        # tile row `row` reads h's tile row row + tap - 2,
                        # the buffer's row row + tap
                        assert torch.equal(frag[lane, i],
                                           h[row + tap, c0 + k: c0 + k + 2])
                        a[row, k: k + 2] = frag[lane, i].double()
            # one wgmma of the slice: each warpgroup's columns
            for wg in (0, 1):
                for j in range(2):
                    b = bt.ring_slice_operand(packed[s].flatten(), wg, 2, j,
                                              kk).double()
                    cols = 192 * wg + 96 * j + torch.arange(96)
                    want = (h[tap: tap + 64, c0: c0 + 16].double()
                            @ w_in[CH * tap + c0: CH * tap + c0 + 16,
                                   cols].double())
                    assert torch.allclose(a @ b.T, want, rtol=0, atol=1e-12)


def test_each_thread_holds_a_channels_tanh_and_sigmoid_halves():
    rows, cols = bt.ring_accumulator_cells(2)
    # every cell of a warpgroup's 64 x 192 once
    cells = (rows * 192 + cols).flatten().sort().values
    assert torch.equal(cells, torch.arange(64 * 192))
    # a register pair: one row, an even column and the next
    assert torch.equal(rows[..., 0::2], rows[..., 1::2])
    assert torch.equal(cols[..., 0::2] % 2, torch.zeros_like(cols[..., 0::2]))
    assert torch.equal(cols[..., 1::2], cols[..., 0::2] + 1)
    # label each pre-gate column of w_in by its own index, interleave as
    # packed: column 2c holds tanh column c, 2c + 1 sigmoid column CH + c
    labels = torch.arange(2 * CH, dtype=torch.float32).expand(K, CH, 2 * CH)
    interleaved = tc.interleave_gate(labels)[0]
    for wg in (0, 1):
        channel = bt.ring_gate_channels(wg, cols[..., 0::2])
        product_col = 192 * wg + cols[..., 0::2]
        assert torch.equal(interleaved[product_col].long(), channel)
        assert torch.equal(interleaved[product_col + 1].long(), CH + channel)
        assert channel.min() == 96 * wg and channel.max() == 96 * wg + 95


def test_ring_weights_of_a_bf16_pack_are_the_f32_weights():
    """The ring body's slices of the weights a bfloat16 pack holds (those
    of BF16_ROUNDED_KEYS rounded, as FlowStep.weights packs them) are the
    slices of the float32 weights: the rounding is the layout's own."""
    w = {**_weights(80, 5), 'an_logs': torch.zeros(80),
         'an_bias': torch.zeros(80), 'b_start': torch.zeros(CH),
         'b_rs': torch.zeros(N, 2 * CH), 'b_end': torch.zeros(80)}
    packed = tc.with_tensor_core_weights(w, torch.bfloat16)
    assert not set(tc.RING_KEYS.values()) & set(packed)
    for name, tensor in tc.ring_weights(packed).items():
        assert torch.equal(tensor, tc.ring_weights(w)[name])


def test_the_twins_constants_are_the_kernels():
    """What the packing and the twins take of the ring body, read from its
    source: the slice depth (a row of B of ``2 D`` bytes), the time tile,
    the 96-column halves of the 1x1s' products, and the phases its timed
    instantiation clocks."""
    import os
    import re
    path = os.path.join(os.path.dirname(tc.__file__), '..', 'csrc',
                        'flow_ring.cuh')
    with open(path, encoding='utf-8') as f:
        source = f.read()
    depth = int(re.search(r'kRingDepth = (\d+)', source).group(1))
    assert depth == tc.RING_DEPTH and bt.ROW_BYTES == 2 * depth
    # a tile is one 64-row block with its halo, at most 48 owned frames
    # (ring_time_tile's first candidate, 64 - NL (KS - 1) = 64 - 2 halo):
    # 48 at the shipped halo of 8 (4 layers of k 5)
    rows = int(re.search(r'R = (\d+), TT = TT_;', source).group(1))
    first, cap = map(int, re.search(
        r'int TT = \((\d+) - NL \* \(KS - 1\) < (\d+)', source).groups())
    assert (rows, first, cap) == (tc.RING_ROWS, tc.RING_ROWS,
                                  tc.RING_MAX_TILE)
    assert min(cap, rows - 2 * tc.SHIPPED_SHAPE.halo) == tc.RING_TIME_TILE
    # the 1x1s' halves: 96 columns each up to C/2 = 96
    half = int(re.search(r'N_SMALL = 2 \* (\d+) \* NWS', source).group(1))
    assert 2 * half == 2 * tc.RING_HALF_SMALL
    enum = re.search(r'enum RingPhase \{(.*?)\};', source, re.S).group(1)
    phases = re.findall(r'^\s*(k\w+)', enum, re.M)
    layers = int(re.search(r'kEnd = kLayer0 \+ (\d+)', enum).group(1))
    assert phases[-1] == 'kRingPhases'
    # kLayer0 stands for its 8 phases, kRingPhases for none
    assert len(phases) - 2 + layers == len(tc.RING_PHASES)


def _coupling_pack(shape):
    """A coupling's own float32 weights (``COUPLING_WEIGHT_KEYS``)."""
    c, ch, n, _ = tc.as_shape(shape)
    w = _weights(shape, 6)
    return {'w_start': w['w_start'], 'b_start': torch.zeros(ch),
            'w_in': w['w_in'], 'w_rs': w['w_rs'],
            'b_rs': torch.zeros(n, 2 * ch), 'w_end': w['w_end'],
            'b_end': torch.zeros(c)}


@pytest.mark.parametrize('c', SHAPES)
def test_the_coupling_reads_the_ring_slices_of_its_own_weights(c):
    """The ring slices the bfloat16 coupling's wrapper reads (its weights'
    ``kernel_key``) are exactly those ``ring_weights`` makes of a coupling's
    pack, at ``ring_shapes``' shapes, with no mixing; ``with_kernel_weights``
    packs them beside the rounded weights, as ``FlowStep.weights`` does."""
    pack = _coupling_pack(c)
    assert set(pack) == set(tc.COUPLING_WEIGHT_KEYS)
    ring = tc.ring_weights(pack)
    read = [tc.kernel_key(key, True, False)
            for key in tc.COUPLING_WEIGHT_KEYS if key in tc.RING_KEYS]
    assert read == list(tc.COUPLING_RING_KEYS) == list(ring)
    assert 'mix_ring' not in ring and len(ring) == 4
    shapes = tc.ring_shapes(c.channels, c.n_layers, c.kernel_size, c.ch)
    for name, tensor in ring.items():
        assert tuple(tensor.shape) == shapes[name], name
        assert tensor.dtype == torch.bfloat16 and tensor.is_contiguous()
    kernel = tc.with_kernel_weights(pack, torch.bfloat16)
    # and, at a WaveNet narrower than the ring body's, the padded copies
    # it reads as they lie
    pads = tc.padded_weights(pack, tc.RING_HALF_BIG)
    assert set(pads) == ({tc.padded_key(key) for key in tc.PAD_KEYS
                          if key in pack} if c.ch != CH else set())
    assert set(kernel) == set(pack) | set(ring) | set(pads)
    for name, tensor in ring.items():
        assert torch.equal(kernel[name], tensor)
    for key in tc.BF16_ROUNDED_KEYS:
        if key in pack:
            assert torch.equal(kernel[key],
                               pack[key].to(torch.bfloat16).float())
    # and at float32 the tensor-core layout, no ring
    f32 = tc.with_kernel_weights(pack, torch.float32)
    assert set(f32) == set(pack) | set(tc.TC_KEYS.values()) | set(
        tc.padded_weights(pack, tc.geometry(c)['ch_pad']))


def test_the_modules_route_hands_the_coupling_its_ring_slices():
    """What ``FlowStep.forward``'s ``'modules'`` route passes the coupling
    of a step's pack is ``COUPLING_PACK_KEYS``: the coupling's own weights,
    their float32 tensor-core layout, their ring slices and GR's pitch
    weights; of a bfloat16 pack, the ring slices but no mixing or
    ActNorm."""
    from glow_tts_tpu_torch.models import decoder
    assert decoder.COUPLING_PACK_KEYS is tc.COUPLING_PACK_KEYS
    keys = set(tc.COUPLING_PACK_KEYS)
    assert set(tc.COUPLING_RING_KEYS) <= keys
    assert set(tc.COUPLING_WEIGHT_KEYS) | set(tc.TC_KEYS.values()) <= keys
    assert 'w_pitch' in keys
    step = {**_coupling_pack(160), 'an_logs': torch.zeros(160),
            'an_bias': torch.zeros(160), 'mix_t': _weights(160)['mix_t']}
    pack = tc.with_kernel_weights(step, torch.bfloat16)
    handed = {key for key in tc.COUPLING_PACK_KEYS if key in pack}
    assert handed == set(tc.COUPLING_WEIGHT_KEYS) | set(
        tc.COUPLING_RING_KEYS)


def test_the_couplings_phases_are_the_flow_steps_without_the_mixing():
    """The timed coupling clocks the ring body's phases (one enum), named
    without the flow step's ActNorm and mixing."""
    assert len(tc.COUPLING_PHASES) == len(tc.RING_PHASES)
    assert tc.COUPLING_PHASES[1:-1] == tc.RING_PHASES[1:-1]
    assert not any('mixing' in name or 'ActNorm' in name
                   for name in tc.COUPLING_PHASES)
