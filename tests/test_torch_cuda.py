"""The CUDA kernels against their plain PyTorch versions on the card.

The flow step at the shipped width (C=160, ch=192, 4 layers, k=5), where
the time tiles and their halos meet the sequence edges: T below, at and
just above one tile, ragged lengths including 1, tiles past every sample's
last valid frame (skipped, exact zeros) on a prefix mask and on one with
holes, and one TF32 pass beside the shipped 3xTF32.  MAS at small and edge
shapes (every tokens-per-lane instantiation, T_tok not a multiple of 32,
odd T_mel, more tokens than frames, lengths out of range, frames far beyond
the old shared-memory limit), equal bit for bit, over buffers planted with
NaN and garbage, twice bit-equal, its timed instantiation equal to it, one
launch (two kernels) a call, and a raise beyond the kernel's token limit.
The train-direction flow stack (forward and backward
kernels) against its plain version and autograd of it: T not a multiple of
the tile, samples of length 1 and of full length, lengths that leave whole
row tiles of the backward GEMMs without a valid frame and that straddle
one, B = 1, dropout rates 0, 0.05 and 0.5, per-sample conditioning, a loss
through the logdet alone or through z alone, the gradients bit-equal
between the stored and the recomputed route, and the backward library's
two GEMMs alone.  The coupling alone: the same tile edges, its two
halves as views of one tensor and as tensors of their own, and what its
wrapper refuses; on ragged masks, with holes and with a sample of length
0, exact zeros past each length over NaN-planted buffers and the tiles it
reports against its twin.  The whole stack in one launch: 1, 2 and 3 steps
(the result lands in either buffer), T below, at and above one tile, fewer
and more (sample, tile) items than resident blocks, against the plain
version and bit for bit against a chain of flow-step launches and against
itself; 12 steps on the same ragged masks over NaN-planted buffers, bit for
bit against the chain and itself, with the tiles it reports against its
twin.  The trainer at the shipped width, batch 2: 2 steps, a restore from
``S_2.pt`` in a new trainer and 2 more against 4 straight steps, the CUDA
generator's state through the checkpoint.
Needs a GPU and nvcc; skipped without.

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.ops import coupling_grad as tg
from glow_tts_tpu_torch.ops import mas as tm

pytestmark = pytest.mark.cuda

# f32 on both sides (TF32 off): only the order of the sums differs
REL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _weights(gen, device, c=160, n=4, k=5, ch=192):
    def rnd(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    w = {
        'w_start': rnd(c // 2, ch, scale=.1), 'b_start': rnd(ch, scale=.1),
        'w_in': rnd(n, k, ch, 2 * ch, scale=.03),
        'w_rs': rnd(n, ch, 2 * ch, scale=.05),
        'b_rs': rnd(n, 2 * ch, scale=.1),
        'w_end': rnd(ch, c, scale=.02), 'b_end': rnd(c, scale=.1),
        'an_logs': rnd(c, scale=.05), 'an_bias': rnd(c, scale=.1),
        'mix_t': torch.linalg.qr(rnd(c, c, scale=1.))[0],
        'ld_const': rnd(scale=.01).reshape(()),
    }
    w['w_rs'][-1, :, :ch] = 0
    w['b_rs'][-1, :ch] = 0
    cond = rnd(n, 4, 2 * ch, scale=.2)
    return (tc.with_tensor_core_weights(
        {key: v.to(device).contiguous() for key, v in w.items()}),
            cond.to(device))


@pytest.fixture
def planted_nan(monkeypatch):
    """Every float tensor that ``torch.empty`` or ``torch.empty_like``
    make is NaN, not whatever the allocator left: a kernel that reads a
    buffer where nothing was written shows it."""
    def planting(make):
        def empty(*args, **kwargs):
            out = make(*args, **kwargs)
            if out.is_floating_point():
                with torch.no_grad():
                    out.fill_(float('nan'))
            return out
        return empty

    monkeypatch.setattr(torch, 'empty', planting(torch.empty))
    monkeypatch.setattr(torch, 'empty_like', planting(torch.empty_like))


@pytest.mark.parametrize('length', [1, 5, 31, 32, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_kernel_matches_plain_at_tile_edges(device, length, reverse):
    gen = torch.Generator().manual_seed(length)
    w, cond = _weights(gen, device)
    lengths = torch.tensor([length, 1, max(length // 2, 1), length])
    mask = (torch.arange(length)[None, :] < lengths[:, None]).float()[..., None]
    x = torch.randn((4, length, 160), generator=gen) * mask
    x, mask = x.to(device), mask.to(device)
    before = tc.flow_step.launches
    z, ld = tc.flow_step(x, mask, w, cond, reverse)
    torch.cuda.synchronize()
    assert tc.flow_step.launches == before + 1
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w, cond, reverse)
    assert ((z - z_ref).abs().max() / z_ref.abs().max().clamp_min(1e-6)
            ) < REL
    assert (z[mask.expand_as(z) == 0] == 0).all()
    if reverse:
        assert ld is None
    else:
        assert ((ld - ld_ref).abs().max()
                / ld_ref.abs().max().clamp_min(1e-6)) < REL


@pytest.mark.parametrize('holes', [False, True])
@pytest.mark.parametrize('reverse', [False, True])
def test_kernel_on_a_ragged_batch_computes_live_tiles_only(device, reverse,
                                                          holes, planted_nan):
    """Lengths 1, one tile, one tile and a frame, T, and a mask with holes
    below the lengths: the tiles past each sample's last valid frame are
    not computed (the kernel's own report says so), and their frames come
    out exactly zero, as the plain version has them, over buffers that
    start as NaN."""
    gen = torch.Generator().manual_seed(7 + holes)
    w, cond = _weights(gen, device)
    t, tile = 512, tc.TIME_TILE
    lengths = torch.tensor([1, tile, tile + 1, t])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    if holes:
        mask[0, 0] = 0                      # no valid frame at all
        mask[2, 5:20] = 0
        mask[3, tile - 3: 3 * tile] = 0
    x = torch.randn((4, t, 160), generator=gen) * 3    # unmasked input
    x, mask = x.to(device), mask.to(device)
    z, ld = tc.flow_step(x, mask, w, cond, reverse)
    torch.cuda.synchronize()
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w, cond, reverse)
    assert _rel(z, z_ref) < REL
    past = (torch.arange(t, device=device)[None, :]
            >= tc.valid_lengths(mask)[:, None])
    assert (z[past] == 0).all() and (z_ref[past] == 0).all()
    assert (z[mask[..., 0] == 0] == 0).all()
    if not reverse:
        assert _rel(ld, ld_ref) < REL
    live = sum(item[2] for item in tc.live_tile_schedule(
        tc.valid_lengths(mask).tolist(), t))
    assert live == (0 if holes else 1) + 1 + 2 + t // tile
    tiles = tc.tile_report(device)
    again, _ = tc._flow_step_kernel(x, mask, w, cond, reverse, tiles=tiles)
    got = dict(zip(tc.TILE_COUNTS, tiles.tolist()))
    assert torch.equal(again, z)
    assert got['live'] == got['computed'] == live
    assert got['items'] == 4 * (t // tile)
    assert got['rounds'] == -(-live // got['blocks'])


@pytest.mark.parametrize('reverse', [False, True])
def test_one_tf32_pass_is_kept_for_measuring(device, reverse):
    """The kernels' one-pass product runs and is further off than the
    shipped 3xTF32 (which holds the f32 bar; one pass may or may not)."""
    gen = torch.Generator().manual_seed(3)
    w, cond = _weights(gen, device)
    x = torch.randn((4, 100, 160), generator=gen).to(device)
    mask = torch.ones((4, 100, 1), device=device)
    ref, _ = tc.flow_step_reference(x, mask, w, cond, reverse)
    three, _ = tc._flow_step_kernel(x, mask, w, cond, reverse, passes=3)
    one, _ = tc._flow_step_kernel(x, mask, w, cond, reverse, passes=1)
    assert _rel(three, ref) < REL
    assert 10 * _rel(three, ref) < _rel(one, ref) < 1e-2


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    gen = torch.Generator().manual_seed(0)
    w, cond = _weights(gen, device)
    x = torch.zeros((4, 8, 160), device=device)
    mask = torch.ones((4, 8, 1), device=device)
    with pytest.raises(NotImplementedError):
        tc.flow_step(x, mask, w, cond, pitch=torch.zeros((4, 8, 2),
                                                         device=device))
    with pytest.raises(ValueError):
        tc.flow_step(x.double(), mask, w, cond)
    with pytest.raises(ValueError):
        tc.flow_step(x[:, :, :80].contiguous(), mask, w, cond)
    # the tensor-core layout is made where the weights are packed, not here
    with pytest.raises(ValueError, match='w_in_tc'):
        tc.flow_step(x, mask, {key: value for key, value in w.items()
                               if key not in tc.TC_KEYS.values()}, cond)
    with pytest.raises(ValueError, match='tiles'):
        tc._flow_step_kernel(x, mask, w, cond, tiles=torch.zeros(
            len(tc.TILE_COUNTS), device=device))


def test_flow_step_refuses_tensors_that_require_grad(device):
    gen = torch.Generator().manual_seed(0)
    w, cond = _weights(gen, device)
    x = torch.zeros((4, 8, 160), device=device, requires_grad=True)
    mask = torch.ones((4, 8, 1), device=device)
    with pytest.raises(RuntimeError, match='no backward'):
        tc.flow_step(x, mask, w, cond)
    with torch.no_grad():
        z, _ = tc.flow_step(x, mask, w, cond)
    assert not z.requires_grad


def _mas_problem(seed, b, t_tok, t_mel, device, lengths=None):
    gen = torch.Generator().manual_seed(seed)
    log_p = torch.randn((b, t_tok, t_mel), generator=gen)
    if lengths is None:
        tl = torch.randint(1, t_tok + 1, (b,), generator=gen)
        ml = torch.randint(1, t_mel + 1, (b,), generator=gen)
        tl[0], ml[0] = t_tok, t_mel
        ml = torch.maximum(ml, tl.clamp_max(t_mel))
    else:
        tl, ml = (torch.tensor(x) for x in lengths)
    mask = ((torch.arange(t_tok)[None, :, None] < tl[:, None, None])
            & (torch.arange(t_mel)[None, None, :] < ml[:, None, None]))
    return ((log_p * mask).to(device), tl.int().to(device),
            ml.int().to(device))


def _check_mas(log_p, tl, ml):
    before = tm.maximum_path.launches
    got = tm.maximum_path(log_p, tl, ml)
    torch.cuda.synchronize()
    assert tm.maximum_path.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == log_p.shape
    assert torch.equal(got, tm.maximum_path_reference(log_p, tl, ml))
    return got


@pytest.mark.parametrize('t_mel', [1, 2, 63, 65, 1000])
@pytest.mark.parametrize('t_tok', [1, 31, 33, 224])
def test_mas_kernel_equals_plain_at_edge_shapes(device, t_tok, t_mel):
    log_p, tl, ml = _mas_problem(t_tok * 1000 + t_mel, 5, t_tok, t_mel,
                                 device)
    got = _check_mas(log_p, tl, ml)
    # one token per valid frame wherever the sample has no more tokens
    # than frames
    fits = tl <= ml
    assert torch.equal(got.sum(dim=(1, 2))[fits], ml[fits].float())


@pytest.mark.parametrize('t_tok', [64, 100, 500, 1024])
def test_mas_kernel_equals_plain_at_every_lane_width(device, t_tok):
    log_p, tl, ml = _mas_problem(t_tok, 2, t_tok, 40, device)
    _check_mas(log_p, tl, ml)


def test_mas_kernel_more_tokens_than_frames_and_unmasked_scores(device):
    lengths = ([12, 7, 2, 1, 40], [5, 3, 1, 1, 37])
    log_p, tl, ml = _mas_problem(3, 5, 40, 37, device, lengths)
    _check_mas(log_p, tl, ml)
    gen = torch.Generator().manual_seed(4)
    raw = torch.randn((5, 40, 37), generator=gen).to(device)
    _check_mas(raw, tl, ml)


def test_mas_wrapper_refuses_what_the_kernel_does_not_take(device):
    log_p, tl, ml = _mas_problem(0, 2, 8, 16, device)
    with pytest.raises(ValueError, match='int32'):
        tm.maximum_path(log_p, tl.long(), ml.long())
    with pytest.raises(ValueError, match='float32'):
        tm.maximum_path(log_p.double(), tl, ml)
    with pytest.raises(ValueError, match='contiguous'):
        tm.maximum_path(log_p.transpose(1, 2), tl, ml)
    with pytest.raises(ValueError, match='at most 1024 tokens'):
        tm.maximum_path(torch.zeros((1, 1025, 4), device=device),
                        tl[:1], ml[:1])
    # no frame limit: the direction bits live in a scratch in device memory
    # (up to 1,303 frames at 1,024 tokens while they lived in shared memory)
    for seed, (b, t_tok, t_mel) in enumerate([(1, 1024, 1400),
                                              (2, 600, 2400),
                                              (1, 1024, 2000)]):
        _check_mas(*_mas_problem(seed, b, t_tok, t_mel, device))


@pytest.fixture
def planted_garbage(monkeypatch):
    """Every tensor that ``torch.empty`` or ``torch.empty_like`` make starts
    as NaN (floats) or 0xAAAAAAAA words (integers): the MAS kernels must
    write every element of the path and every scratch word they read."""
    def planting(make):
        def empty(*args, **kwargs):
            out = make(*args, **kwargs)
            with torch.no_grad():
                out.fill_(float('nan') if out.is_floating_point()
                          else -0x55555556)
            return out
        return empty

    monkeypatch.setattr(torch, 'empty', planting(torch.empty))
    monkeypatch.setattr(torch, 'empty_like', planting(torch.empty_like))


@pytest.mark.parametrize('t_tok,t_mel', [(37, 93), (224, 1023), (300, 514),
                                         (1024, 61)])
def test_mas_writes_every_element_over_planted_buffers(device,
                                                       planted_garbage,
                                                       t_tok, t_mel):
    log_p, tl, ml = _mas_problem(t_tok + t_mel, 4, t_tok, t_mel, device)
    got = _check_mas(log_p, tl, ml)
    assert not got.isnan().any()


def test_mas_lengths_out_of_range_and_token_0_guard(device):
    """No token, more tokens than log_p has, no frame and more frames than
    it has, as the plain version has them; and a path that stays on token
    0 while that token's value sinks below the illegal score (its
    direction bit set, the walk's guard holding it at 0)."""
    log_p, _, _ = _mas_problem(5, 4, 6, 12, device)
    tl = torch.tensor([0, 7, 6, 3], dtype=torch.int32, device=device)
    ml = torch.tensor([12, 12, 0, 20], dtype=torch.int32, device=device)
    _check_mas(log_p, tl, ml)
    stays = torch.zeros((1, 3, 12), device=device)
    stays[0, 0], stays[0, 1:] = -2e8, -5e8
    got = _check_mas(stays, tl[3:].clamp_max(3), ml[:1])
    assert torch.equal(got[0].argmax(dim=0).cpu(),
                       torch.tensor([0] * 10 + [1, 2]))


def test_mas_runs_are_bit_equal_and_count_one_launch(device):
    log_p, tl, ml = _mas_problem(9, 32, 224, 1024, device)
    launches, kernels = tm.maximum_path.launches, tm.maximum_path.kernels
    first = tm.maximum_path(log_p, tl, ml)
    second = tm.maximum_path(log_p, tl, ml)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert tm.maximum_path.launches == launches + 2
    assert tm.maximum_path.kernels == kernels + 4   # recurrence, expansion


def test_mas_timed_instantiation_gives_the_same_path(device):
    log_p, tl, ml = _mas_problem(10, 8, 224, 700, device)
    launches = tm.maximum_path.launches
    timed, split = tm.maximum_path_timed(log_p, tl, ml)
    assert tm.maximum_path.launches == launches     # not counted
    assert torch.equal(timed, tm.maximum_path(log_p, tl, ml))
    assert split['frames'] == int(ml.max())
    assert all(value >= 0 for value in split['phases_ns'].values())
    assert split['cycles_a_frame'] > 0


def _stack_weights(gen, device, steps=2, c=160, n=4, k=5, ch=192):
    def rnd(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    w = {
        'w_start': rnd(steps, c // 2, ch, scale=.1),
        'b_start': rnd(steps, ch, scale=.1),
        'w_in': rnd(steps, n, k, ch, 2 * ch, scale=.03),
        'b_in': rnd(steps, n, 2 * ch, scale=.1),
        'w_rs': rnd(steps, n, ch, 2 * ch, scale=.05),
        'b_rs': rnd(steps, n, 2 * ch, scale=.1),
        'w_end': rnd(steps, ch, c, scale=.02),
        'b_end': rnd(steps, c, scale=.1),
        'an_logs': rnd(steps, c, scale=.05),
        'an_bias': rnd(steps, c, scale=.1),
        'mix_t': torch.stack([torch.linalg.qr(rnd(c, c, scale=1.))[0]
                              for _ in range(steps)]),
        'ld_const': rnd(steps, scale=.01),
    }
    w['w_rs'][:, -1, :, :ch] = 0
    w['b_rs'][:, -1, :ch] = 0
    return {key: v.to(device).contiguous() for key, v in w.items()}


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def _train_both(device, lengths, rate, with_cond=False, z_weight=1.0,
                ld_weight=0.7, seed=11, route=None, holes=()):
    """Kernel and plain version on the same leaves; returns the two
    results as dicts of values and gradients.  ``route`` forces what the
    kernels' forward pass leaves for the backward pass (``'store'`` or
    ``'recompute'``) instead of the rule by the shapes; ``holes`` are
    ``(sample, first frame, end frame)`` spans masked out below the
    sample's length."""
    def kernels(xl, mask, leaves, cl, seed, dropout_rate):
        return tg._apply_kernels(xl, mask, leaves, cl, seed, dropout_rate,
                                 route)

    gen = torch.Generator().manual_seed(sum(lengths) + len(lengths))
    b, t = len(lengths), max(lengths)
    weights = _stack_weights(gen, device)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None]
    for sample, first, end in holes:
        mask[sample, first:end] = 0
    x = (torch.randn((b, t, 160), generator=gen) * mask).to(device)
    zt = torch.randn((b, t, 160), generator=gen).to(device)
    wl = torch.arange(1., b + 1.).to(device)
    cond = (torch.randn((2, 4, b, 384), generator=gen) * .2).to(device) \
        if with_cond else None
    mask = mask.to(device)
    results = []
    for fn in (tg.flow_stack_train if route is None else kernels,
               tg.flow_stack_train_reference):
        leaves = {key: v.clone().requires_grad_()
                  for key, v in weights.items()}
        xl = x.clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, cl, seed=seed, dropout_rate=rate)
        (z_weight * torch.sum(z * zt)
         + ld_weight * torch.sum(ld * wl)).backward()
        torch.cuda.synchronize()
        out = {'z': z.detach(), 'ld': ld.detach(), 'dx': xl.grad,
               **{f'd{key}': leaf.grad for key, leaf in leaves.items()}}
        if cl is not None:
            out['dcond'] = cl.grad
        results.append(out)
    return results


def _assert_train_agrees(got, ref):
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert torch.isfinite(got[key]).all(), key
        assert _rel(got[key], value) < REL, (key, _rel(got[key], value))
    # the last layer feeds the skip half only
    assert (got['dw_rs'][:, -1, :, :192] == 0).all()
    assert (got['db_rs'][:, -1, :192] == 0).all()


@pytest.mark.parametrize('rate', [0.0, 0.05, 0.5])
@pytest.mark.parametrize('lengths', [[1], [5, 1], [33, 1, 16, 33],
                                     [70, 35, 1, 70, 64], [200, 1, 130],
                                     [129, 128, 127]])
def test_train_kernels_match_plain_at_tile_edges(device, lengths, rate):
    fwd, rec, bwd = (tg.flow_stack_train.forward_launches,
                     tg.flow_stack_train.recompute_launches,
                     tg.flow_stack_train.backward_launches)
    got, ref = _train_both(device, lengths, rate)
    # two flow steps: a forward launch each, which stores at this size (no
    # recompute), and the backward library's 22 kernels each
    assert tg.backward_launches_per_step(4) == 22
    assert tg.flow_stack_train.forward_launches == fwd + 2
    assert tg.flow_stack_train.recompute_launches == rec
    assert tg.flow_stack_train.backward_launches == bwd + 2 * 22
    _assert_train_agrees(got, ref)
    pad = got['z'][torch.arange(max(lengths), device=device)[None, :]
                   >= torch.tensor(lengths, device=device)[:, None]]
    assert (pad == 0).all()


@pytest.mark.parametrize('rate', [0.0, 0.05])
def test_train_kernels_with_per_sample_conditioning(device, rate):
    got, ref = _train_both(device, [40, 17, 1], rate, with_cond=True)
    _assert_train_agrees(got, ref)
    assert got['dcond'].abs().max() > 0


@pytest.mark.parametrize('z_weight,ld_weight', [(0.0, 0.7), (1.0, 0.0)])
def test_train_backward_through_one_output_alone(device, z_weight,
                                                 ld_weight):
    got, ref = _train_both(device, [45, 20], 0.05, z_weight=z_weight,
                           ld_weight=ld_weight)
    _assert_train_agrees(got, ref)


def test_train_gradients_are_bit_equal_across_runs(device):
    a, _ = _train_both(device, [70, 35, 1], 0.05)
    b, _ = _train_both(device, [70, 35, 1], 0.05)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize('with_cond', [False, True])
@pytest.mark.parametrize('lengths', [[70, 35, 1], [200, 1, 130]])
def test_train_stored_and_recomputed_routes_are_bit_equal(device, lengths,
                                                          with_cond):
    rec = tg.flow_stack_train.recompute_launches
    stored, ref = _train_both(device, lengths, 0.05, with_cond=with_cond,
                              route='store')
    assert tg.flow_stack_train.recompute_launches == rec
    recomputed, _ = _train_both(device, lengths, 0.05, with_cond=with_cond,
                                route='recompute')
    assert tg.flow_stack_train.recompute_launches == rec + 2
    _assert_train_agrees(recomputed, ref)
    for key in stored:
        assert torch.equal(stored[key], recomputed[key]), key


def test_train_kernels_take_a_mask_with_holes(device):
    """The backward skips frames past a sample's last valid one, not every
    masked frame: a mask that is not a prefix gives the plain version's
    gradients too."""
    got, ref = _train_both(device, [150, 70, 140], 0.05,
                           holes=[(0, 10, 45), (1, 0, 3), (2, 127, 130)])
    _assert_train_agrees(got, ref)


@pytest.mark.parametrize('route', ['store', 'recompute'])
def test_train_gradients_ignore_rows_left_unwritten(device, planted_nan,
                                                    route):
    """Dead tiles write none of the saved values past a sample's length
    (but the layers' inputs up to PAD frames on), and every buffer here
    starts as NaN: no gradient may read those rows.  A mask with holes, a
    sample of length 1 and one whose last tiles are dead; the routes give
    the plain version's gradients, finite, and the same bits."""
    lengths, holes = [150, 70, 1, 140], [(0, 10, 45), (1, 0, 3),
                                         (3, 127, 130)]
    got, ref = _train_both(device, lengths, 0.05, route=route, holes=holes)
    _assert_train_agrees(got, ref)
    other, _ = _train_both(device, lengths, 0.05, holes=holes,
                           route={'store': 'recompute',
                                  'recompute': 'store'}[route])
    for key in got:
        assert torch.equal(got[key], other[key]), key


def test_train_forward_reports_the_live_tiles_it_computed(device):
    gen = torch.Generator().manual_seed(6)
    w = _stack_weights(gen, device)
    x, mask = _ragged(gen, [70, 35, 1, 0], device)
    tiles = tc.tile_report(device)
    with torch.no_grad():
        tg._apply_kernels(x, mask, w, None, 4, 0.05, 'store', tiles=tiles)
    got = dict(zip(tc.TILE_COUNTS, tiles.tolist()))
    live = 3 + 2 + 1
    assert got['live'] == live and got['items'] == 4 * 3
    assert got['computed'] == 2 * live        # two flow steps
    assert got['rounds'] == -(-live // got['blocks'])


def test_train_forward_one_tf32_pass_is_kept_for_measuring(device):
    gen = torch.Generator().manual_seed(5)
    w = _stack_weights(gen, device)
    lengths = torch.tensor([90, 33, 1])
    mask = (torch.arange(90)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn((3, 90, 160), generator=gen) * mask).to(device)
    mask = mask.to(device)
    with torch.no_grad():
        ref, _ = tg.flow_stack_train_reference(x, mask, w, seed=4,
                                               dropout_rate=0.05)
        three, _ = tg._apply_kernels(x, mask, w, None, 4, 0.05)
        one, _ = tg._apply_kernels(x, mask, w, None, 4, 0.05,
                                   forward_passes=1)
    assert _rel(three, ref) < REL
    assert 10 * _rel(three, ref) < _rel(one, ref) < 1e-2
    with pytest.raises(ValueError, match='measuring'):
        tg._apply_kernels(x, mask, w, None, 4, 0.05, 'store',
                          forward_passes=1)


def test_train_forward_without_gradient_keeps_nothing_for_backward(device):
    """Under ``no_grad`` and with no leaf requiring grad the forward pass
    takes the instantiation that saves nothing; its outputs are the same
    bits as the storing one's."""
    gen = torch.Generator().manual_seed(3)
    w = _stack_weights(gen, device)
    x, mask = _ragged(gen, [70, 35, 1], device)
    z_plain, ld_plain = tg.flow_stack_train(x, mask, w, seed=5,
                                            dropout_rate=0.05)
    assert z_plain.grad_fn is None
    leaves = {key: v.clone().requires_grad_() for key, v in w.items()}
    with torch.no_grad():
        z_off, _ = tg.flow_stack_train(x, mask, leaves, seed=5,
                                       dropout_rate=0.05)
    z_on, ld_on = tg.flow_stack_train(x, mask, leaves, seed=5,
                                      dropout_rate=0.05)
    assert z_on.grad_fn is not None
    assert torch.equal(z_on, z_plain) and torch.equal(z_off, z_plain)
    assert torch.equal(ld_on, ld_plain)


@pytest.mark.parametrize('lengths', [[40], [200, 1, 130, 0],
                                     [129, 128, 127]])
@pytest.mark.parametrize('kseg,taps,width', [(384, 5, 192), (160, 1, 192),
                                             (192, 1, 80), (160, 1, 160)])
def test_backward_dgrad_product_matches_matmul(device, lengths, kseg, taps,
                                               width):
    gen = torch.Generator().manual_seed(kseg + taps + sum(lengths))
    t, pad = max(lengths), (taps - 1) // 2
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None].to(device)
    a = torch.randn((len(lengths), t, kseg), generator=gen).to(device) * mask
    w = (torch.randn((taps, width, kseg), generator=gen) * .1).to(device)
    padded = torch.nn.functional.pad(a, (0, 0, pad, pad)).double()
    ref = sum(padded[:, 2 * pad - tap: 2 * pad - tap + t]
              @ w[tap].double().T for tap in range(taps)) * mask
    got = tg._dgrad_product(a, w, mask)
    # 3xTF32 against f64: the tensor cores' f32 accumulation truncates, so
    # the error grows with the depth (1.3e-5 at 1,920); a single pass is
    # ten times worse and more
    assert _rel(got.double(), ref) < REL / 2
    assert (got[(mask == 0).expand_as(got)] == 0).all()
    one_pass = tg._dgrad_product(a, w, mask, passes=1)
    assert REL < _rel(one_pass.double(), ref) < 5e-3


@pytest.mark.parametrize('lengths', [[40], [200, 1, 130, 0],
                                     [129, 128, 127]])
@pytest.mark.parametrize('kseg,taps,width', [(192, 5, 384), (192, 1, 160),
                                             (80, 1, 192), (160, 1, 160)])
def test_backward_wgrad_product_matches_matmul(device, lengths, kseg, taps,
                                               width):
    gen = torch.Generator().manual_seed(kseg + taps + sum(lengths))
    t, pad = max(lengths), (taps - 1) // 2
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None].to(device)
    p = torch.randn((len(lengths), t, kseg), generator=gen).to(device)
    g = torch.randn((len(lengths), t, width), generator=gen).to(device) * mask
    padded = torch.nn.functional.pad(p, (0, 0, pad, pad)).double()
    ref = torch.cat([torch.einsum('btk,btn->kn', padded[:, tap: tap + t],
                                  g.double()) for tap in range(taps)])
    got = tg._wgrad_product(p, g, mask, taps)
    assert _rel(got.double(), ref) < REL / 2
    assert torch.equal(got, tg._wgrad_product(p, g, mask, taps))


def test_train_wrapper_refuses_what_the_kernels_do_not_take(device):
    gen = torch.Generator().manual_seed(0)
    w = _stack_weights(gen, device)
    x = torch.zeros((2, 8, 160), device=device)
    mask = torch.ones((2, 8, 1), device=device)
    with pytest.raises(NotImplementedError):
        tg.flow_stack_train(x, mask, w, None,
                            torch.zeros((2, 8, 2), device=device), seed=0)
    with pytest.raises(ValueError, match='float32'):
        tg.flow_stack_train(x.double(), mask, w, seed=0)
    with pytest.raises(ValueError, match='built for'):
        tg.flow_stack_train(x[:, :, :80].contiguous(), mask, w, seed=0)
    with pytest.raises(ValueError, match='cond'):
        tg.flow_stack_train(x, mask, w,
                            torch.zeros((2, 4, 3, 384), device=device),
                            seed=0)
    with pytest.raises(ValueError, match='dropout_rate'):
        tg.flow_stack_train(x, mask, w, seed=0, dropout_rate=1.0)


def _ragged(gen, lengths, device, c=160):
    t = max(lengths)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None]
    x = torch.randn((len(lengths), t, c), generator=gen) * mask
    return x.to(device), mask.to(device)


@pytest.mark.parametrize('length', [1, 5, 31, 32, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('views', [True, False])
def test_coupling_kernel_matches_plain_at_tile_edges(device, length, reverse,
                                                     views):
    gen = torch.Generator().manual_seed(100 + length)
    w, cond = _weights(gen, device)
    x, mask = _ragged(gen, [length, 1, max(length // 2, 1), length], device)
    x_a, x_b = x[..., :80], x[..., 80:]
    if not views:
        x_a, x_b = x_a.contiguous(), x_b.contiguous()
    before = tc.coupling.launches
    z_b, ld = tc.coupling(x_a, x_b, mask, w, cond, reverse=reverse)
    torch.cuda.synchronize()
    assert tc.coupling.launches == before + 1
    z_ref, ld_ref = tc.coupling_reference(x_a, x_b, mask, w, cond,
                                          reverse=reverse)
    assert z_b.shape == (4, length, 80) and z_b.is_contiguous()
    assert _rel(z_b, z_ref) < REL
    assert (z_b[mask.expand_as(z_b) == 0] == 0).all()
    if reverse:
        assert ld is None
    else:
        assert _rel(ld, ld_ref) < REL


def test_coupling_round_trip(device):
    gen = torch.Generator().manual_seed(7)
    w, cond = _weights(gen, device)
    x, mask = _ragged(gen, [70, 1, 35, 64], device)
    x_a, x_b = x[..., :80], x[..., 80:]
    z_b, _ = tc.coupling(x_a, x_b, mask, w, cond)
    back, _ = tc.coupling(x_a, z_b, mask, w, cond, reverse=True)
    assert _rel(back, x_b) < 1e-5


def test_coupling_wrapper_refuses_what_the_kernel_does_not_take(device):
    gen = torch.Generator().manual_seed(0)
    w, cond = _weights(gen, device)
    x = torch.zeros((4, 8, 168), device=device)
    x_a, x_b = x[..., :80], x[..., 80:160]
    mask = torch.ones((4, 8, 1), device=device)
    tc.coupling(x_a, x_b, mask, w, cond)                # a wider parent runs
    with pytest.raises(NotImplementedError):
        tc.coupling(x_a, x_b, mask, w, cond,
                    pitch=torch.zeros((4, 8, 2), device=device))
    with pytest.raises(ValueError, match='float32'):
        tc.coupling(x_a.double(), x_b, mask, w, cond)
    with pytest.raises(ValueError, match='built for'):
        tc.coupling(x[..., :40], x[..., 40:80], mask, w, cond)
    with pytest.raises(ValueError, match='16-byte'):     # rows off by 4 bytes
        tc.coupling(x[..., 1:81], x_b, mask, w, cond)
    with pytest.raises(ValueError, match='unit stride'):
        tc.coupling(x[..., 0:160:2], x_b, mask, w, cond)
    with pytest.raises(ValueError, match='cond'):
        tc.coupling(x_a, x_b, mask, w, cond[:, :3].contiguous())
    with pytest.raises(RuntimeError, match='no backward'):
        tc.coupling(x_a.clone().requires_grad_(), x_b, mask, w, cond)


def _stack_problem(gen, device, steps, lengths):
    w = _stack_weights(gen, device, steps=steps)
    del w['b_in']
    w = tc.with_tensor_core_weights(w)
    x, mask = _ragged(gen, lengths, device)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    return x, mask, w, cond


def _chain(x, mask, w, cond, reverse):
    """The same steps as one flow-step launch each."""
    steps = w['w_in'].shape[0]
    lds = []
    for s in (reversed(range(steps)) if reverse else range(steps)):
        x, ld = tc.flow_step(
            x, mask, {key: value[s] for key, value in w.items()},
            cond[s].contiguous(), reverse)
        lds.append(ld)
    return x, (None if reverse else torch.stack(lds).sum(dim=0))


# 34 x 5 tiles is more items than an H100 has SMs: some blocks walk two
@pytest.mark.parametrize('lengths', [[1], [33, 1, 16, 33],
                                     [70, 35, 1, 70, 64],
                                     [130, 7] + [100] * 32])
@pytest.mark.parametrize('steps', [1, 2, 3])
@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_kernel_matches_plain_and_the_chain(device, lengths,
                                                       steps, reverse):
    gen = torch.Generator().manual_seed(sum(lengths) + steps)
    x, mask, w, cond = _stack_problem(gen, device, steps, lengths)
    before = tc.flow_stack.launches
    z, ld = tc.flow_stack(x, mask, w, cond, reverse=reverse)
    torch.cuda.synchronize()
    assert tc.flow_stack.launches == before + 1        # one for all steps
    z_ref, ld_ref = tc.flow_stack_reference(x, mask, w, cond,
                                            reverse=reverse)
    assert _rel(z, z_ref) < REL
    assert (z[mask.expand_as(z) == 0] == 0).all()
    z_chain, ld_chain = _chain(x, mask, w, cond, reverse)
    assert torch.equal(z, z_chain)
    again, ld_again = tc.flow_stack(x, mask, w, cond, reverse=reverse)
    assert torch.equal(z, again)
    if reverse:
        assert ld is None
    else:
        assert _rel(ld, ld_ref) < REL
        assert _rel(ld, ld_chain) < 1e-5       # other order of the sums
        assert torch.equal(ld, ld_again)


# (lengths, holes): frames [a, b) of sample i set to 0 inside its length
RAGGED_STACKS = [
    ([1, 32, 33, 512, 200], {}),
    ([512, 70, 300, 64], {0: (40, 100), 2: (31, 140)}),
    ([0, 512, 17, 96], {}),                      # a sample of length 0
]


def _ragged_mask(lengths, holes, t, device):
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()
    for i, (a, b) in holes.items():
        mask[i, a:b] = 0
    return mask[..., None].to(device)


def _expected_report(live, items, blocks):
    """What a launch over ``items`` with ``live`` live ones on ``blocks``
    blocks reports (``tc.TILE_COUNTS``)."""
    return {'live': live, 'items': items, 'computed': live,
            'rounds': -(-live // blocks), 'blocks': blocks}


@pytest.mark.parametrize('case', range(len(RAGGED_STACKS)))
@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_on_a_ragged_batch_is_the_chain_bit_for_bit(
        device, case, reverse, planted_nan):
    """12 steps over ragged lengths, a mask with holes and a sample of
    length 0, every fresh buffer NaN: z bit-equal to 12 chained flow-step
    launches and to a second run, exact zeros past each length, the logdet
    within f32 order of the chain's and equal to the second run's, and the
    tiles the kernel reports equal to its twin's (every live tile once a
    step, no dead one, ceil(12 L / G) rounds)."""
    lengths, holes = RAGGED_STACKS[case]
    t, steps = 512, 12
    gen = torch.Generator().manual_seed(40 + case)
    w = _stack_weights(gen, device, steps=steps)
    del w['b_in']
    w = tc.with_tensor_core_weights(w)
    mask = _ragged_mask(lengths, holes, t, device)
    x = (torch.randn((len(lengths), t, 160), generator=gen) * 3).to(device)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    tiles = tc.tile_report(device)
    z, ld = tc._flow_stack_kernel(x, mask, w, cond, reverse=reverse,
                                  tiles=tiles)
    again, ld_again = tc.flow_stack(x, mask, w, cond, reverse=reverse)
    z_chain, ld_chain = _chain(x, mask, w, cond, reverse)
    torch.cuda.synchronize()
    assert torch.isfinite(z).all()
    assert torch.equal(z, z_chain) and torch.equal(z, again)
    past = (torch.arange(t, device=device)[None, :]
            >= tc.valid_lengths(mask)[:, None])
    assert (z[past] == 0).all() and (z[mask[..., 0] == 0] == 0).all()
    if not reverse:
        assert torch.isfinite(ld).all() and torch.equal(ld, ld_again)
        assert _rel(ld, ld_chain) < 1e-5       # other order of the sums
    items = tc.stack_tile_schedule(tc.valid_lengths(mask).tolist(), t, steps)
    blocks = min(tc.load_flow_stack_library().glow_flow_stack_resident_blocks(
        len(lengths)), steps * len(lengths) * (t // tc.TIME_TILE))
    assert dict(zip(tc.TILE_COUNTS, tiles.tolist())) == _expected_report(
        sum(item.live for item in items), len(items), blocks)


@pytest.mark.parametrize('case', range(len(RAGGED_STACKS)))
@pytest.mark.parametrize('reverse', [False, True])
def test_coupling_on_a_ragged_batch_computes_live_tiles_only(
        device, case, reverse, planted_nan):
    """The coupling over the same ragged masks, NaN in every fresh buffer:
    the plain version's result with exact zeros past each length, and the
    tiles the kernel reports equal to its twin's."""
    lengths, holes = RAGGED_STACKS[case]
    t = 512
    gen = torch.Generator().manual_seed(50 + case)
    w, _ = _weights(gen, device)
    mask = _ragged_mask(lengths, holes, t, device)
    x = (torch.randn((len(lengths), t, 160), generator=gen) * 3).to(device)
    cond = (torch.randn((4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    x_a, x_b = x[..., :80], x[..., 80:]
    tiles = tc.tile_report(device)
    z_b, ld = tc._coupling_kernel(x_a, x_b, mask, w, cond, reverse=reverse,
                                  tiles=tiles)
    torch.cuda.synchronize()
    z_ref, ld_ref = tc.coupling_reference(x_a, x_b, mask, w, cond,
                                          reverse=reverse)
    assert torch.isfinite(z_b).all()
    assert _rel(z_b, z_ref) < REL
    past = (torch.arange(t, device=device)[None, :]
            >= tc.valid_lengths(mask)[:, None])
    assert (z_b[past] == 0).all() and (z_ref[past] == 0).all()
    if not reverse:
        assert _rel(ld, ld_ref) < REL
    items = tc.live_tile_schedule(tc.valid_lengths(mask).tolist(), t)
    blocks = min(tc.load_coupling_library().glow_coupling_resident_blocks(
        len(lengths)), len(items))
    assert dict(zip(tc.TILE_COUNTS, tiles.tolist())) == _expected_report(
        sum(live for _, _, live in items), len(items), blocks)


def test_flow_stack_grid_is_the_resident_blocks(device):
    lib = tc.load_flow_stack_library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for b in (1, 32, 256):                      # 138 KB a block and the list
        assert lib.glow_flow_stack_resident_blocks(b) == sms


def test_flow_stack_wrapper_refuses_what_the_kernel_does_not_take(device):
    gen = torch.Generator().manual_seed(0)
    x, mask, w, cond = _stack_problem(gen, device, 2, [8, 8])
    with pytest.raises(NotImplementedError):
        tc.flow_stack(x, mask, w, cond,
                      pitch=torch.zeros((2, 8, 2), device=device))
    with pytest.raises(ValueError, match='float32'):
        tc.flow_stack(x.double(), mask, w, cond)
    with pytest.raises(ValueError, match='built for'):
        tc.flow_stack(x[:, :, :80].contiguous(), mask, w, cond)
    with pytest.raises(ValueError, match='cond'):
        tc.flow_stack(x, mask, w, cond[:1])
    with pytest.raises(ValueError, match='ld_const'):
        tc.flow_stack(x, mask, dict(w, ld_const=w['ld_const'][:1]), cond)
    with pytest.raises(RuntimeError, match='no backward'):
        tc.flow_stack(x.clone().requires_grad_(), mask, w, cond)


def test_trainer_resumes_on_the_card(device, tmp_path):
    """The trainer at the shipped width, batch 2, on 6 train patterns (3
    batches an epoch) with dropout on: 2 steps, a new ``Trainer`` that
    restores ``S_2.pt`` (the CUDA generator's philox state with it) and 2
    more, against 4 straight steps, with cuDNN as the trainer sets it;
    every parameter within 1e-5 of its max-abs, as ``chip_smoke.py``
    holds them."""
    import dataclasses
    import os
    from glow_tts_tpu_torch.config import PatternConfig, load_config
    from glow_tts_tpu_torch.training.trainer import Trainer
    from glow_tts_tpu_torch.utils.logging import NullWriter
    # from the test directory, which pytest puts on the path: a package
    # named ``tests`` elsewhere on the path may hide this one
    from torch_patterns import write_pattern_archive

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, 'configs', 'Hyper_Parameters.yaml'))
    root = str(tmp_path)
    write_pattern_archive(f'{root}/train', 6, cfg.sound, 0, mel=(50, 200),
                          text=(10, 40))
    write_pattern_archive(f'{root}/eval', 3, cfg.sound, 1, mel=(50, 200),
                          text=(10, 40))

    def trainer(run, max_step):
        train = dataclasses.replace(
            cfg.train, batch_size=2, num_workers=2, max_step=max_step,
            train_pattern=PatternConfig(path=f'{root}/train'),
            eval_pattern=PatternConfig(path=f'{root}/eval'),
            checkpoint_save_interval=2, logging_interval=2,
            evaluation_interval=4, inference_interval=100)
        null = NullWriter()
        return Trainer(dataclasses.replace(
            cfg, train=train, checkpoint_path=f'{root}/{run}/ckpt',
            log_path=f'{root}/{run}/log'), device=device,
            max_mel_length=256, writers={'train': null, 'eval': null})

    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = False
    try:
        whole = trainer('whole', 4)
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        whole.train()
        trainer('resumed', 2).train()
        resumed = trainer('resumed', 4)
        assert resumed.step == 2
        resumed.train()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    assert resumed.optimizer.count == whole.optimizer.count == 4
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    for (name, a), (_, b) in zip(whole.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert _rel(b, a) <= 1e-5, name
