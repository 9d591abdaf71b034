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
generator's state through the checkpoint.  GR mode's pitch operand in the
flow step, the coupling and the stack: the same tile edges (a live tile
whose halo crosses its sample's end and T), ragged masks with holes, the
stack bit for bit against a chain of flow-step launches with pitch, and
what the wrappers refuse.  GR mode's pitch operand in the train kernels'
pitch builds: the forward's three instantiations (no gradient wanted,
storing, and the backward's recompute) and the backward against the plain
version and autograd of it at tile edges and at a train batch's ragged
lengths, ``dw_pitch`` and ``dpitch`` included, bit-equal twice and between
the stored and the recomputed route, ``dpitch`` skipped when the pitch
wants no gradient, and one GR train step at the shipped width against the
same step through the plain versions.  MiniSpeech's 80-channel builds
(``Num_Squeeze: 1``) of the flow step, the coupling, the stack and the
train pair: each library reports its width, each against its plain
version at tile edges and on ragged masks (the stack bit for bit against
the chain), their launches counted apart, the backward's activation-
gradient product over a depth of 80 (not a multiple of its 32-deep
slice), the routes bit-equal, the pitch operand 1 wide at 80 channels
(a 2-wide one refused), and one EM + freeze train step at MiniSpeech's config against the plain
versions.  The bfloat16 builds (``GLOW_BF16``) of the flow step and the
train pair at 160 and 80 channels, with the conditioning rows and the pitch
operand: each against its bfloat16 plain version with the f32 plain version
as the reference (max|kernel − plain_bf16| ≤ 2·max|plain_bf16 − plain_f32|
+ 1e-6 on values; gradients within 3e-2 norm-relative of the f32 ones and
at most twice the bf16 plain version's distance from them, plus 1e-4),
counted apart, the stored and recomputed routes bit-equal.  The bfloat16
builds of the coupling (#2) and of the stack (#4) at 160 and 80 channels
and with the pitch operand: #2 against its bf16 plain version to the same
bar, its halves as views of one bfloat16 tensor; #4 bit for bit against a
chain of the flow step's bf16 launches (the stream bfloat16 between the
steps) and to the bar against its plain version.  The pitch operand 1
wide at 80 channels (the 80-channel pitch builds) in every flow kernel, at f32
and bf16, against the plain versions, and the 2-wide operand refused
there.  The Hopper body of #3's, #4's and #2's bf16 builds
(``csrc/flow_ring.cuh``) at every build and in both directions: two runs
bit-equal, NaN planted in x past each sample's length and in the dead tiles
reaching neither z nor the logdet (and, for #2, in the other columns of the
wider tensor its halves are views of), #4 bit for bit against 12 launches
of #3, #2's z_b and logdet bit for bit against #3's on an identity ActNorm
and mixing with its tiles against its 48-frame schedule, a ragged B = 33
with T not a multiple of its 48-frame tile, B = 1 at the tile's edges, a
bf16 view off 16-byte alignment refused, and the timed instantiations equal
to the kernels.  #3, #2 and #4 at the decoder shapes of ROADMAP B.2
(100-bin mels' C = 200 with and without the pitch operand, tiny_config's
decoder, a WaveNet of 16 layers of k 3, 128 wide), f32 and bf16: each
against its plain version on a ragged batch, #4 bit for bit against
chained #3 launches, #2 bf16 bit for bit against #3 bf16 on an identity,
the C = 200 bf16 halves read as they lie (8-byte loads) and a view off
that alignment refused, and each library's geometry equal to
``ops/coupling.py::geometry``'s.  #5 and #6 at those builds and at (C
160, ch 80, 2 layers; the f32 start conv's 80-deep activation gradient
takes the tail), f32 and bf16 (ROADMAP B.2's train half): against the
plain version at dropout 0 and 0.05, counted on each build's counters,
the stored and recomputed routes and two runs bit-equal on a mask with
holes, the dropout masks of the padded widths element by element (the
true 2ch's), #5's geometry reported and #6's reduction sized by the
layers, and a bf16 ch 20 and C = 200 at 8 layers refused naming B.2
before any launch (the f32 ch 20 taken).
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
    # a pitch operand goes with w_pitch among the weights
    with pytest.raises(ValueError, match='w_pitch'):
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
                ld_weight=0.7, seed=11, route=None, holes=(),
                with_pitch=False, pitch_grad=True, c=160):
    """Kernel and plain version on the same leaves; returns the two
    results as dicts of values and gradients.  ``route`` forces what the
    kernels' forward pass leaves for the backward pass (``'store'`` or
    ``'recompute'``) instead of the rule by the shapes; ``holes`` are
    ``(sample, first frame, end frame)`` spans masked out below the
    sample's length.  ``with_pitch`` adds GR mode's pitch operand (not zero
    past the lengths) and ``w_pitch``; the pitch is a leaf that requires a
    gradient unless ``pitch_grad`` is false.  ``c`` is the flow's width
    (80: MiniSpeech's build)."""
    def kernels(xl, mask, leaves, cl, pl, seed, dropout_rate):
        return tg._apply_kernels(xl, mask, leaves, cl, seed, dropout_rate,
                                 route, pitch=pl)

    gen = torch.Generator().manual_seed(sum(lengths) + len(lengths))
    b, t = len(lengths), max(lengths)
    weights = _stack_weights(gen, device, c=c)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None]
    for sample, first, end in holes:
        mask[sample, first:end] = 0
    x = (torch.randn((b, t, c), generator=gen) * mask).to(device)
    zt = torch.randn((b, t, c), generator=gen).to(device)
    wl = torch.arange(1., b + 1.).to(device)
    cond = (torch.randn((2, 4, b, 384), generator=gen) * .2).to(device) \
        if with_cond else None
    pitch = None
    if with_pitch:
        ps = tc.default_pitch_size(c)
        weights['w_pitch'] = (torch.randn((2, 4, ps, 384),
                                          generator=gen) * .5).to(device)
        pitch = torch.rand((b, t, ps), generator=gen).to(device)
    mask = mask.to(device)
    results = []
    for fn in (tg.flow_stack_train if route is None else kernels,
               tg.flow_stack_train_reference):
        leaves = {key: v.clone().requires_grad_()
                  for key, v in weights.items()}
        xl = x.clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_(
            pitch_grad)
        z, ld = fn(xl, mask, leaves, cl, pl, seed=seed, dropout_rate=rate)
        (z_weight * torch.sum(z * zt)
         + ld_weight * torch.sum(ld * wl)).backward()
        torch.cuda.synchronize()
        out = {'z': z.detach(), 'ld': ld.detach(), 'dx': xl.grad,
               **{f'd{key}': leaf.grad for key, leaf in leaves.items()}}
        if cl is not None:
            out['dcond'] = cl.grad
        if pl is not None and pitch_grad:
            out['dpitch'] = pl.grad
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
    # a pitch operand without its weight, or of another width
    with pytest.raises(ValueError, match='w_pitch'):
        tg.flow_stack_train(x, mask, w, None,
                            torch.zeros((2, 8, 2), device=device), seed=0)
    w_pitch = torch.zeros((2, 4, 2, 384), device=device)
    with pytest.raises(ValueError, match='pitch'):
        tg.flow_stack_train(x, mask, {**w, 'w_pitch': w_pitch}, None,
                            torch.zeros((2, 8, 3), device=device), seed=0)
    with pytest.raises(ValueError, match='w_pitch'):
        tg.flow_stack_train(x, mask, {**w, 'w_pitch': w_pitch[:, :3]}, None,
                            torch.zeros((2, 8, 2), device=device), seed=0)
    with pytest.raises(ValueError, match='float32'):
        tg.flow_stack_train(x.double(), mask, w, seed=0)
    # 96 channels are a train build of their own: the weights of 160 are
    # not its
    with pytest.raises(ValueError, match='an_logs'):
        tg.flow_stack_train(x[:, :, :96].contiguous(), mask, w, seed=0)
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
    with pytest.raises(ValueError, match='w_pitch'):
        tc.coupling(x_a, x_b, mask, w, cond,
                    pitch=torch.zeros((4, 8, 2), device=device))
    with pytest.raises(ValueError, match='float32'):
        tc.coupling(x_a.double(), x_b, mask, w, cond)
    # a width outside the envelope (not a multiple of 8); one inside it
    # whose weights are another width's
    with pytest.raises(ValueError, match='ROADMAP.md B.2'):
        tc.coupling(x[..., :50], x[..., 50:100], mask, w, cond)
    with pytest.raises(ValueError, match='w_start'):
        tc.coupling(x[..., :48], x[..., 48:96], mask, w, cond)
    with pytest.raises(ValueError, match='aligned to 4'):  # rows off by 4 bytes
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
    with pytest.raises(ValueError, match='w_pitch'):
        tc.flow_stack(x, mask, w, cond,
                      pitch=torch.zeros((2, 8, 2), device=device))
    with pytest.raises(ValueError, match='float32'):
        tc.flow_stack(x.double(), mask, w, cond)
    with pytest.raises(ValueError, match='ROADMAP.md B.2'):
        tc.flow_stack(x[:, :, :100].contiguous(), mask, w, cond)
    with pytest.raises(ValueError, match='an_logs'):
        tc.flow_stack(x[:, :, :96].contiguous(), mask, w, cond)
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


def _with_pitch(gen, w, b, t, device, steps=None, c=160):
    """``w`` with a ``w_pitch [(steps,) 4, ps, 384]``, and a pitch operand
    ``[B, T, ps]`` that is not zero past the samples' lengths either; ``ps``
    the width at ``c`` flow channels (2 at 160, 1 at 80)."""
    lead = () if steps is None else (steps,)
    ps = tc.default_pitch_size(c)
    w_pitch = torch.randn(lead + (4, ps, 384), generator=gen) * .5
    pitch = torch.rand((b, t, ps), generator=gen)
    return {**w, 'w_pitch': w_pitch.to(device)}, pitch.to(device)


@pytest.mark.parametrize('length', [1, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_flow_step_with_pitch_matches_plain(device, length, reverse):
    gen = torch.Generator().manual_seed(100 + length)
    w, cond = _weights(gen, device)
    x, mask = _ragged(gen, [length, 1, max(length // 2, 1), length], device)
    w, pitch = _with_pitch(gen, w, 4, length, device)
    before = tc.flow_step.launches, tc.flow_step.pitch_launches
    z, ld = tc.flow_step(x, mask, w, cond, reverse, pitch=pitch)
    torch.cuda.synchronize()
    # the pitch instantiation counts its own launches
    assert (tc.flow_step.launches, tc.flow_step.pitch_launches) == (
        before[0], before[1] + 1)
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w, cond, reverse, pitch)
    assert _rel(z, z_ref) < REL
    assert (z[mask.expand_as(z) == 0] == 0).all()
    # the pitch term is there: without it the result is another one
    z_without, _ = tc.flow_step_reference(x, mask, w, cond, reverse)
    assert _rel(z_without, z_ref) > 100 * REL
    if not reverse:
        assert _rel(ld, ld_ref) < 1e-5


@pytest.mark.parametrize('length', [5, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_coupling_with_pitch_matches_plain(device, length, reverse):
    gen = torch.Generator().manual_seed(200 + length)
    w, cond = _weights(gen, device)
    x, mask = _ragged(gen, [length, 1, max(length // 2, 1), length], device)
    w, pitch = _with_pitch(gen, w, 4, length, device)
    x_a, x_b = x[..., :80], x[..., 80:]
    z, ld = tc.coupling(x_a, x_b, mask, w, cond, pitch=pitch,
                        reverse=reverse)
    torch.cuda.synchronize()
    z_ref, ld_ref = tc.coupling_reference(x_a, x_b, mask, w, cond, pitch,
                                          reverse)
    assert _rel(z, z_ref) < REL
    if not reverse:
        assert _rel(ld, ld_ref) < 1e-5


@pytest.mark.parametrize('lengths', [[33, 1, 16, 33], [130, 7] + [100] * 32])
@pytest.mark.parametrize('reverse', [False, True])
def test_flow_stack_with_pitch_matches_plain_and_the_chain(device, lengths,
                                                           reverse):
    gen = torch.Generator().manual_seed(300 + sum(lengths))
    x, mask, w, cond = _stack_problem(gen, device, 3, lengths)
    w, pitch = _with_pitch(gen, w, len(lengths), x.shape[1], device, steps=3)
    z, ld = tc.flow_stack(x, mask, w, cond, pitch, reverse)
    torch.cuda.synchronize()
    z_ref, ld_ref = tc.flow_stack_reference(x, mask, w, cond, pitch, reverse)
    assert _rel(z, z_ref) < REL
    chain = x
    for s in (reversed(range(3)) if reverse else range(3)):
        chain, _ = tc.flow_step(chain, mask,
                                {key: value[s] for key, value in w.items()},
                                cond[s].contiguous(), reverse, pitch=pitch)
    assert torch.equal(z, chain)
    if not reverse:
        assert _rel(ld, ld_ref) < REL


@pytest.mark.parametrize('case', range(len(RAGGED_STACKS)))
def test_flow_stack_with_pitch_on_masks_with_holes(device, planted_nan, case):
    lengths, holes = RAGGED_STACKS[case]
    gen = torch.Generator().manual_seed(400 + case)
    w, _ = _weights(gen, device)
    stacked = {key: torch.stack([value] * 2) for key, value in w.items()}
    mask = _ragged_mask(lengths, holes, 512, device)
    x = torch.randn((len(lengths), 512, 160), generator=gen).to(device) * mask
    cond = (torch.randn((2, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    stacked, pitch = _with_pitch(gen, stacked, len(lengths), 512, device,
                                 steps=2)
    for reverse in (False, True):
        z, _ = tc.flow_stack(x, mask, stacked, cond, pitch, reverse)
        z_ref, _ = tc.flow_stack_reference(x, mask, stacked, cond, pitch,
                                           reverse)
        torch.cuda.synchronize()
        assert torch.isfinite(z).all()
        assert _rel(z, z_ref) < REL


def test_pitch_wrappers_refuse_what_the_kernels_do_not_take(device):
    gen = torch.Generator().manual_seed(1)
    w, cond = _weights(gen, device)
    x = torch.zeros((4, 8, 160), device=device)
    mask = torch.ones((4, 8, 1), device=device)
    w, pitch = _with_pitch(gen, w, 4, 8, device)
    tc.flow_step(x, mask, w, cond, pitch=pitch)
    with pytest.raises(ValueError, match='pitch'):     # ps = num_squeeze = 2
        tc.flow_step(x, mask, w, cond, pitch=torch.zeros((4, 8, 3),
                                                         device=device))
    with pytest.raises(ValueError, match='pitch'):
        tc.flow_step(x, mask, w, cond, pitch=pitch[:, :4].contiguous())
    with pytest.raises(ValueError, match='w_pitch'):
        tc.flow_step(x, mask, {**w, 'w_pitch': w['w_pitch'][:3]}, cond,
                     pitch=pitch)
    with pytest.raises(ValueError, match='pitch'):
        tc.coupling(x[..., :80], x[..., 80:], mask, w, cond,
                    pitch=pitch.transpose(1, 2).contiguous().transpose(1, 2))


def _pitch_counts():
    train = tg.flow_stack_train
    return {name: getattr(train, name) for name in (
        'forward_launches', 'recompute_launches', 'backward_launches',
        'forward_pitch_launches', 'recompute_pitch_launches',
        'backward_pitch_launches')}


# a train batch's ragged lengths (squeezed frames of 32 samples of 25 ...
# 500 frames in a 512-frame bucket), from a seed
TRAIN_BATCH_LENGTHS = torch.randint(
    25, 501, (32,), generator=torch.Generator().manual_seed(9)).tolist()


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('lengths', [[1], [33, 1, 16, 33], [200, 1, 130],
                                     TRAIN_BATCH_LENGTHS])
def test_train_pitch_builds_match_plain(device, lengths, rate):
    """#5 (storing) and #6 of the pitch builds against the plain version
    and autograd of it, with per-sample conditioning: z 1e-4 and logdet
    1e-5 relative, every gradient (``dw_pitch`` and ``dpitch`` among them)
    within 1e-4 of its max-abs; the launches counted as the pitch builds'
    own, 26 backward kernels a flow step."""
    before = _pitch_counts()
    got, ref = _train_both(device, lengths, rate, with_cond=True,
                           with_pitch=True)
    counts = _pitch_counts()
    assert tg.backward_launches_per_step(4, pitch=True) == 26
    assert {key: counts[key] - before[key] for key in counts} == {
        'forward_launches': 0, 'recompute_launches': 0,
        'backward_launches': 0, 'forward_pitch_launches': 2,
        'recompute_pitch_launches': 0, 'backward_pitch_launches': 2 * 26}
    assert _rel(got['ld'], ref['ld']) < 1e-5
    _assert_train_agrees(got, ref)
    assert got['dw_pitch'].abs().max() > 0 and got['dpitch'].abs().max() > 0
    # the pitch gradient is zero where the mask is
    mask = (torch.arange(max(lengths), device=device)[None, :]
            < torch.tensor(lengths, device=device)[:, None])
    assert (got['dpitch'][~mask] == 0).all()


def test_train_pitch_builds_are_bit_equal_across_runs_and_routes(device):
    """The storing forward, the recompute launches and the backward of the
    pitch builds: two runs of each route the same bits, and the two routes
    the same bits, on a mask with holes."""
    lengths, holes = [150, 70, 1, 140], [(0, 10, 45), (3, 127, 130)]
    runs = {route: [_train_both(device, lengths, 0.05, with_cond=True,
                                with_pitch=True, route=route,
                                holes=holes)[0] for _ in range(2)]
            for route in ('store', 'recompute')}
    _, ref = _train_both(device, lengths, 0.05, with_cond=True,
                         with_pitch=True, holes=holes)
    first = runs['store'][0]
    _assert_train_agrees(first, ref)
    for route, (a, b) in runs.items():
        for key in first:
            assert torch.equal(a[key], b[key]), (route, key)
            assert torch.equal(a[key], first[key]), (route, key)


def test_train_pitch_builds_skip_dpitch_when_no_gradient_is_wanted(device):
    """A pitch that wants no gradient (the model's, which comes from the
    data): the other gradients are the same bits as with ``dpitch``; the
    forward without any gradient (the instantiation that saves nothing) is
    the same bits as the storing one."""
    lengths = [70, 35, 1]
    with_grad, _ = _train_both(device, lengths, 0.05, with_cond=True,
                               with_pitch=True)
    without, ref = _train_both(device, lengths, 0.05, with_cond=True,
                               with_pitch=True, pitch_grad=False)
    assert 'dpitch' not in without
    _assert_train_agrees(without, ref)
    for key in without:
        assert torch.equal(without[key], with_grad[key]), key
    gen = torch.Generator().manual_seed(sum(lengths) + len(lengths))
    w = _stack_weights(gen, device)
    x, mask = _ragged(gen, lengths, device)
    cond = (torch.randn((2, 4, 3, 384), generator=gen) * .2).to(device)
    w['w_pitch'] = (torch.randn((2, 4, 2, 384), generator=gen) * .5
                    ).to(device)
    pitch = torch.rand((3, 70, 2), generator=gen).to(device)
    with torch.no_grad():
        z_off, ld_off = tg.flow_stack_train(x, mask, w, cond, pitch, seed=5,
                                            dropout_rate=0.05)
        z_ref, _ = tg.flow_stack_train_reference(x, mask, w, cond, pitch,
                                                 seed=5, dropout_rate=0.05)
    leaves = {key: v.clone().requires_grad_() for key, v in w.items()}
    z_on, ld_on = tg.flow_stack_train(x, mask, leaves, cond, pitch, seed=5,
                                      dropout_rate=0.05)
    assert torch.equal(z_on.detach(), z_off)
    assert torch.equal(ld_on.detach(), ld_off)
    assert _rel(z_off, z_ref) < REL


def test_gr_train_step_on_the_card_matches_the_plain_versions(device):
    """One GR train step at the shipped width (batch 4 from
    ``TrainCollater``: speakers, pitch tracks), random weights (every
    coupling live), after the conditioned ActNorm init, through the kernels (#3's, #5's and #6's pitch builds,
    MAS) and through the plain versions from the same weights, seed and
    generator state: losses within 1e-4, the gradient norm within 1e-3,
    as ``chip_smoke.py`` holds them."""
    import dataclasses
    import os

    import numpy as np
    import yaml
    from glow_tts_tpu_torch import (TrainCollater, batch_to_device,
                                    load_config, make_optimizer,
                                    make_train_step, random_state_dict)
    from glow_tts_tpu_torch.models.glow_tts import GlowTTS
    from glow_tts_tpu_torch.text import Tokenizer
    from glow_tts_tpu_torch.weights import load_state_dict

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'configs', 'Hyper_Parameters.yaml')) as f:
        data = yaml.safe_load(f)
    data['Mode'] = 'GR'
    cfg = load_config(data)
    rng = np.random.default_rng(3)
    items = [{'text': 'THE BIRCH CANOE SLID ON THE SMOOTH PLANKS.'[:n],
              'mel': rng.uniform(-4, 4, (m, 80)).astype(np.float32),
              'speaker_id': int(rng.integers(cfg.speaker_embedding
                                             .num_speakers)),
              'pitch': rng.random(m).astype(np.float32)}
             for n, m in ((40, 300), (12, 90), (30, 211), (20, 150))]
    batch = batch_to_device(TrainCollater(cfg, Tokenizer())(items), device)
    state = random_state_dict(cfg, 0)           # live couplings
    metrics = {}
    for name, fns in (('kernels', {}), (
            'plain', {'stack_fn': tg.flow_stack_train_reference,
                      'mas_fn': tm.maximum_path_reference})):
        model = load_state_dict(GlowTTS(cfg), state).to(device).prepare(
            fold=False)
        model.data_dependent_init(
            batch['mels'], batch['mel_lengths'],
            step_fn=tc.flow_step if name == 'kernels'
            else tc.flow_step_reference,
            speakers=batch['speakers'], pitches=batch['pitches'])
        step = make_train_step(
            cfg, model, make_optimizer(cfg, model.parameters()), seed=0,
            generator=torch.Generator(device=device).manual_seed(0), **fns)
        before = _pitch_counts()
        metrics[name] = {key: value.item()
                         for key, value in step(batch).items()}
        counts = _pitch_counts()
        if name == 'kernels':
            assert {key: counts[key] - before[key] for key in counts} == {
                'forward_launches': 0, 'recompute_launches': 0,
                'backward_launches': 0, 'forward_pitch_launches': 12,
                'recompute_pitch_launches': 0,
                'backward_pitch_launches': 12 * 26}
    got, ref = metrics['kernels'], metrics['plain']
    assert set(got) == {'mle', 'duration', 'speaker', 'total', 'grad_norm'}
    for key, value in ref.items():
        bar = 1e-3 if key == 'grad_norm' else 1e-4
        assert np.isfinite(got[key]), key
        assert abs(got[key] - value) <= bar * abs(value), (key, got, ref)


# ---------------------------------------------------------------------------
# the 80-channel builds (MiniSpeech, Num_Squeeze 1)
# ---------------------------------------------------------------------------

C80 = 80


def test_each_build_reports_its_width(device):
    for load in (tc.load_flow_step_library, tc.load_coupling_library,
                 tc.load_flow_stack_library, tg.load_train_forward_library,
                 tg.load_train_backward_library):
        for channels in (160, C80):
            assert load(channels=channels).glow_flow_channels() == channels


def _c80_counts():
    return {f'{fn.__name__}.{name}': getattr(fn, name) for fn, names in (
        (tc.flow_step, ('launches', 'c80_launches')),
        (tc.coupling, ('launches', 'c80_launches')),
        (tc.flow_stack, ('launches', 'c80_launches')),
        (tg.flow_stack_train, ('forward_launches', 'forward_c80_launches',
                               'backward_launches', 'backward_c80_launches',
                               'recompute_c80_launches')))
        for name in names}


def _moved(before):
    after = _c80_counts()
    return {key: after[key] - before[key] for key in after
            if after[key] != before[key]}


@pytest.mark.parametrize('length', [1, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_c80_flow_step_matches_plain(device, length, reverse):
    gen = torch.Generator().manual_seed(200 + length)
    w, cond = _weights(gen, device, c=C80)
    x, mask = _ragged(gen, [length, 1, max(length // 2, 1), length], device,
                      c=C80)
    before = _c80_counts()
    z, ld = tc.flow_step(x, mask, w, cond, reverse)
    torch.cuda.synchronize()
    assert _moved(before) == {'flow_step.c80_launches': 1}
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w, cond, reverse)
    assert _rel(z, z_ref) < REL
    assert (z[mask.expand_as(z) == 0] == 0).all()
    if not reverse:
        assert _rel(ld, ld_ref) < REL
    # the other direction takes the inverse mixing
    inverse = dict(w, mix_t=torch.linalg.inv(w['mix_t']).contiguous())
    back, _ = tc.flow_step(z, mask, inverse, cond, not reverse)
    assert _rel(back, x) < 1e-4


@pytest.mark.parametrize('lengths', [[70, 1, 35, 64], [512, 33, 1]])
@pytest.mark.parametrize('reverse', [False, True])
def test_c80_coupling_matches_plain(device, lengths, reverse, planted_nan):
    gen = torch.Generator().manual_seed(210 + len(lengths))
    w, _ = _weights(gen, device, c=C80)
    x, mask = _ragged(gen, lengths, device, c=C80)
    cond = (torch.randn((4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    x_a, x_b = x[..., :40], x[..., 40:]           # views of one tensor
    before = _c80_counts()
    tiles = tc.tile_report(device)
    z_b, ld = tc._coupling_kernel(x_a, x_b, mask, w, cond, reverse=reverse,
                                  tiles=tiles)
    torch.cuda.synchronize()
    z_ref, ld_ref = tc.coupling_reference(x_a, x_b, mask, w, cond,
                                          reverse=reverse)
    assert torch.isfinite(z_b).all() and _rel(z_b, z_ref) < REL
    assert (z_b[mask.expand_as(z_b) == 0] == 0).all()
    if not reverse:
        assert _rel(ld, ld_ref) < REL
    items = tc.live_tile_schedule(tc.valid_lengths(mask).tolist(),
                                  x.shape[1])
    got = dict(zip(tc.TILE_COUNTS, tiles.tolist()))
    assert got['live'] == got['computed'] == sum(
        live for _, _, live in items)
    z_b2, _ = tc.coupling(x_a.contiguous(), x_b.contiguous(), mask, w, cond,
                          reverse=reverse)
    assert torch.equal(z_b, z_b2)
    assert _moved(before) == {'coupling.c80_launches': 2}


@pytest.mark.parametrize('case', range(len(RAGGED_STACKS)))
@pytest.mark.parametrize('reverse', [False, True])
def test_c80_flow_stack_is_the_chain_bit_for_bit(device, case, reverse,
                                                 planted_nan):
    lengths, holes = RAGGED_STACKS[case]
    t, steps = 512, 12
    gen = torch.Generator().manual_seed(220 + case)
    w = _stack_weights(gen, device, steps=steps, c=C80)
    del w['b_in']
    w = tc.with_tensor_core_weights(w)
    mask = _ragged_mask(lengths, holes, t, device)
    x = (torch.randn((len(lengths), t, C80), generator=gen) * 3).to(device)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    before = _c80_counts()
    z, ld = tc.flow_stack(x, mask, w, cond, reverse=reverse)
    assert _moved(before) == {'flow_stack.c80_launches': 1}
    z_chain, ld_chain = _chain(x, mask, w, cond, reverse)
    z_ref, ld_ref = tc.flow_stack_reference(x, mask, w, cond,
                                            reverse=reverse)
    torch.cuda.synchronize()
    assert torch.isfinite(z).all() and torch.equal(z, z_chain)
    assert _rel(z, z_ref) < REL
    assert (z[mask[..., 0] == 0] == 0).all()
    if not reverse:
        assert _rel(ld, ld_chain) < 1e-5 and _rel(ld, ld_ref) < REL


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('lengths', [[1], [33, 1, 16, 33], [200, 1, 130],
                                     [129, 128, 127]])
def test_c80_train_kernels_match_plain(device, lengths, rate):
    before = _c80_counts()
    got, ref = _train_both(device, lengths, rate, c=C80)
    assert _moved(before) == {
        'flow_stack_train.forward_c80_launches': 2,
        'flow_stack_train.backward_c80_launches': 2 * 22}
    _assert_train_agrees(got, ref)


@pytest.mark.parametrize('with_cond', [False, True])
def test_c80_train_routes_and_runs_are_bit_equal(device, with_cond):
    lengths = [200, 1, 130]
    stored, ref = _train_both(device, lengths, 0.05, with_cond=with_cond,
                              route='store', c=C80)
    again, _ = _train_both(device, lengths, 0.05, with_cond=with_cond,
                           route='store', c=C80)
    before = _c80_counts()
    recomputed, _ = _train_both(device, lengths, 0.05, with_cond=with_cond,
                                route='recompute', c=C80)
    assert _moved(before)[
        'flow_stack_train.recompute_c80_launches'] == 2
    _assert_train_agrees(recomputed, ref)
    for key in stored:
        assert torch.equal(stored[key], recomputed[key]), key
        assert torch.equal(stored[key], again[key]), key


@pytest.mark.parametrize('lengths', [[40], [200, 1, 130, 0]])
@pytest.mark.parametrize('width', [192, 80])
def test_c80_backward_dgrad_over_a_depth_of_80(device, lengths, width):
    """The end conv's and the mixing's activation gradients contract over
    C = 80, which is not a multiple of the 32-deep slice: the last slice is
    zero-filled past the depth."""
    gen = torch.Generator().manual_seed(230 + width + sum(lengths))
    t = max(lengths)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None].to(device)
    a = torch.randn((len(lengths), t, C80), generator=gen).to(device) * mask
    w = (torch.randn((1, width, C80), generator=gen) * .1).to(device)
    ref = (a.double() @ w[0].double().T) * mask
    got = tg._dgrad_product(a, w, mask, channels=C80)
    assert _rel(got.double(), ref) < REL / 2
    assert (got[(mask == 0).expand_as(got)] == 0).all()
    with pytest.raises(ValueError, match='dgrad'):
        tg._dgrad_product(a, w, mask)          # the 160 build: 32-deep only


def test_c80_refuses_the_pitch_operand(device):
    """At 80 channels (``Num_Squeeze: 1``) the pitch operand is 1 wide: the
    flow step and the train stack take it (their 80-channel pitch
    builds, counted apart) and match their plain versions.  A 2-wide
    operand (num_squeeze 2, 40 mel bins) is what the train stack refuses
    (ROADMAP.md B.2's train half); the flow step takes it, in the build
    of that width (``GLOW_PITCH_SIZE=2``), as the JAX package does."""
    gen = torch.Generator().manual_seed(240)
    w, cond = _weights(gen, device, c=C80)
    x, mask = _ragged(gen, [8, 3, 8, 1], device, c=C80)
    w, pitch = _with_pitch(gen, w, 4, 8, device, c=C80)
    assert pitch.shape[-1] == 1
    before = tc.flow_step.c80_pitch_launches
    z, ld = tc.flow_step(x, mask, w, cond, pitch=pitch)
    torch.cuda.synchronize()
    assert tc.flow_step.c80_pitch_launches == before + 1
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w, cond, pitch=pitch)
    assert _rel(z, z_ref) < REL and _rel(ld, ld_ref) < REL
    w2 = dict(w, w_pitch=torch.randn((4, 2, 384), generator=gen).to(device))
    pitch2 = torch.rand((4, 8, 2), generator=gen).to(device)
    z2, ld2 = tc.flow_step(x, mask, w2, cond, pitch=pitch2)
    torch.cuda.synchronize()
    assert tc.flow_step.c80_pitch2_launches >= 1
    z_ref, ld_ref = tc.flow_step_reference(x, mask, w2, cond, pitch=pitch2)
    assert _rel(z2, z_ref) < REL and _rel(ld2, ld_ref) < REL
    stack = _stack_weights(gen, device, c=C80)
    stack['w_pitch'] = torch.zeros((2, 4, 2, 384), device=device)
    with pytest.raises(ValueError, match='B.2, the train half'):
        tg.flow_stack_train(x, mask, stack, None,
                            torch.zeros((4, 8, 2), device=device), seed=0)
    before = tg.flow_stack_train.forward_c80_pitch_launches
    got, ref = _train_both(device, [8, 3, 8, 1], 0.05, with_pitch=True,
                           c=C80)
    assert tg.flow_stack_train.forward_c80_pitch_launches == before + 2
    _assert_train_agrees(got, ref)


def test_c80_em_freeze_train_step_matches_the_plain_versions(device):
    """One EM + freeze train step at ``configs/MiniSpeech.yaml`` (80 flow
    channels), batch 4 of the EM-lockable corpus's kind (pause token 2 on
    silent frames), random weights, through the kernels (#5 and #6 at 80
    channels, MAS twice) and through the plain versions from the same
    weights, seed and generator state: losses within 1e-4, the gradient
    norm within 1e-3, the EM statistics within 1e-4, the decoder
    bit-unchanged in both."""
    import os
    import warnings

    import numpy as np
    from glow_tts_tpu_torch import (load_config, make_optimizer,
                                    random_state_dict)
    from glow_tts_tpu_torch.models.glow_tts import GlowTTS
    from glow_tts_tpu_torch.training.step import (EMState, init_em_stats,
                                                  make_train_step)
    from glow_tts_tpu_torch.weights import load_state_dict

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # its bf16: the port runs f32
        cfg = load_config(os.path.join(repo, 'configs', 'MiniSpeech.yaml'))
    rng = np.random.default_rng(5)
    b, t_tok, t_mel = 4, 24, 160
    tokens = rng.integers(3, 13, (b, t_tok)).astype(np.int64)
    tokens[:, 2::3] = 2
    token_lengths = np.array([24, 20, 9, 15])
    mel_lengths = np.array([160, 120, 60, 100])
    owners = np.minimum(np.arange(t_mel)[None, :] * token_lengths[:, None]
                        // mel_lengths[:, None], t_tok - 1)
    signatures = rng.normal(0, 2, (13, 80))
    mels = np.take_along_axis(tokens, owners, 1)
    mels = np.where((mels == 2)[..., None], -4.0, signatures[mels])
    mels = mels + rng.normal(0, 0.1, mels.shape)
    mels[np.arange(t_mel)[None, :] >= mel_lengths[:, None]] = -4.0
    batch = {key: torch.as_tensor(value).to(device) for key, value in {
        'tokens': np.where(np.arange(t_tok)[None] < token_lengths[:, None],
                           tokens, 0),
        'token_lengths': token_lengths.astype(np.int32),
        'mels': mels.astype(np.float32),
        'mel_lengths': mel_lengths.astype(np.int32)}.items()}
    state = random_state_dict(cfg, 0)
    results = {}
    for name, fns in (('kernels', {}), (
            'plain', {'stack_fn': tg.flow_stack_train_reference,
                      'mas_fn': tm.maximum_path_reference})):
        model = load_state_dict(GlowTTS(cfg), state).to(device).prepare(
            fold=False)
        model.data_dependent_init(
            batch['mels'], batch['mel_lengths'],
            step_fn=tc.flow_step if name == 'kernels'
            else tc.flow_step_reference)
        decoder = {key: p.detach().clone() for key, p in
                   model.layer_Dict['Decoder'].named_parameters()}
        em = EMState(init_em_stats(cfg, device))
        step = make_train_step(
            cfg, model, make_optimizer(cfg, model.parameters()), seed=0,
            generator=torch.Generator(device=device).manual_seed(0),
            em_alignment=True, freeze_decoder=True, em_state=em, **fns)
        before = _c80_counts()
        mas_before = tm.maximum_path.launches
        metrics = {key: value.item() for key, value in step(batch).items()}
        if name == 'kernels':
            assert _moved(before) == {
                'flow_stack_train.forward_c80_launches': 12,
                'flow_stack_train.backward_c80_launches': 12 * 22}
            assert tm.maximum_path.launches == mas_before + 2
        for key, p in model.layer_Dict['Decoder'].named_parameters():
            assert torch.equal(p, decoder[key]), key
        results[name] = metrics, em.stats
    (got, got_stats), (ref, ref_stats) = results['kernels'], results['plain']
    assert set(got) == {'mle', 'duration', 'distill', 'total', 'grad_norm'}
    for key, value in ref.items():
        bar = 1e-3 if key == 'grad_norm' else 1e-4
        assert np.isfinite(got[key]), key
        assert abs(got[key] - value) <= bar * abs(value), (key, got, ref)
    for a, r in zip(got_stats, ref_stats):
        assert _rel(a, r) < 1e-4


# ---------------------------------------------------------------------------
# the bfloat16 builds (GLOW_BF16) of #3, #5 and #6
# ---------------------------------------------------------------------------

def _bf16_err(kernel, plain16, plain32):
    """(max|kernel − plain_bf16|, the bar 2·max|plain_bf16 − plain_f32| +
    1e-6): the bf16 tolerance of tests/torch_port_helpers.py, with the
    plain versions as the reference."""
    kernel, plain16, plain32 = (v.float() for v in (kernel, plain16,
                                                    plain32))
    return ((kernel - plain16).abs().max().item(),
            2 * (plain16 - plain32).abs().max().item() + 1e-6)


def _norm_rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item()


def _bf16_pack(w):
    """``w`` as the bfloat16 builds take it: the tensor-core layout and the
    rounded weights, and the ring body's slices (``FlowStep.weights``
    packs the same once)."""
    return {**tc.with_tensor_core_weights(w, torch.bfloat16),
            **tc.ring_weights(w)}


def _bf16_counts():
    return (tc.flow_step.bf16_launches, tc.flow_step.bf16_pitch_launches,
            tc.flow_step.bf16_c80_launches)


@pytest.mark.parametrize('c', [160, 80])
@pytest.mark.parametrize('length', [1, 33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_flow_step_matches_plain(device, c, length, reverse):
    gen = torch.Generator().manual_seed(length + c)
    w, cond = _weights(gen, device, c=c)
    lengths = torch.tensor([length, 1, max(length // 2, 1), length])
    mask = (torch.arange(length)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn((4, length, c), generator=gen) * mask).to(device)
    x16, mask = x.to(torch.bfloat16), mask.to(device)
    w16 = _bf16_pack(w)
    assert w16['w_in_tc'].dtype == torch.bfloat16
    before = _bf16_counts()
    z, ld = tc.flow_step(x16, mask, w16, cond, reverse)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert sum(after) - sum(before) == 1
    assert (after[2] > before[2]) == (c == 80)
    assert z.dtype == torch.bfloat16
    z16, ld16 = tc.flow_step_reference(x16, mask, w, cond, reverse)
    z32, ld32 = tc.flow_step_reference(x16.float(), mask, w, cond, reverse)
    err, bar = _bf16_err(z, z16, z32)
    assert err <= bar, (err, bar)
    assert (z[mask.expand_as(z) == 0] == 0).all()
    if not reverse:
        err, bar = _bf16_err(ld, ld16, ld32)
        assert err <= bar, (err, bar)


@pytest.mark.parametrize('length', [33, 70])
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_flow_step_with_pitch_matches_plain(device, length, reverse):
    gen = torch.Generator().manual_seed(length)
    w, cond = _weights(gen, device)
    mask = torch.ones((4, length, 1), device=device)
    x = torch.randn((4, length, 160), generator=gen).to(device)
    w, pitch = _with_pitch(gen, w, 4, length, device)
    x16 = x.to(torch.bfloat16)
    before = tc.flow_step.bf16_pitch_launches
    z, _ = tc.flow_step(x16, mask, _bf16_pack(w), cond, reverse, pitch=pitch)
    torch.cuda.synchronize()
    assert tc.flow_step.bf16_pitch_launches == before + 1
    z16, _ = tc.flow_step_reference(x16, mask, w, cond, reverse, pitch)
    z32, _ = tc.flow_step_reference(x16.float(), mask, w, cond, reverse,
                                    pitch)
    err, bar = _bf16_err(z, z16, z32)
    assert err <= bar, (err, bar)


def _train_bf16(device, lengths, rate, with_cond=False, with_pitch=False,
                c=160, route=None, passes=None, seed=5):
    """The train stack's bf16 kernels, its bf16 plain version and its f32
    plain version on the same leaves (x rounded to bf16 for all three):
    three dicts of values and gradients."""
    gen = torch.Generator().manual_seed(sum(lengths) + c)
    b, t = len(lengths), max(lengths)
    weights = _stack_weights(gen, device, c=c)
    mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
            ).float()[..., None].to(device)
    x = (torch.randn((b, t, c), generator=gen).to(device) * mask).to(
        torch.bfloat16)
    zt = torch.randn((b, t, c), generator=gen).to(device)
    wl = torch.arange(1., b + 1.).to(device)
    cond = ((torch.randn((2, 4, b, 384), generator=gen) * .2).to(device)
            if with_cond else None)
    pitch = None
    if with_pitch:
        ps = tc.default_pitch_size(c)
        weights['w_pitch'] = (torch.randn((2, 4, ps, 384),
                                          generator=gen) * .5).to(device)
        pitch = torch.rand((b, t, ps), generator=gen).to(device)

    def kernels(xl, mask_, leaves, cl, pl, seed, dropout_rate):
        return tg._apply_kernels(xl, mask_, leaves, cl, seed, dropout_rate,
                                 route, passes=passes, pitch=pl)

    results = []
    for fn, dtype in ((kernels, torch.bfloat16),
                      (tg.flow_stack_train_reference, torch.bfloat16),
                      (tg.flow_stack_train_reference, torch.float32)):
        leaves = {key: v.clone().requires_grad_()
                  for key, v in weights.items()}
        xl = x.to(dtype).detach().clone().requires_grad_()
        cl = None if cond is None else cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, cl, pl, seed=seed, dropout_rate=rate)
        (torch.sum(z.float() * zt) + 0.7 * torch.sum(ld * wl)).backward()
        torch.cuda.synchronize()
        out = {'z': z.detach().float(), 'ld': ld.detach(),
               'dx': xl.grad.float(),
               **{f'd{key}': leaf.grad for key, leaf in leaves.items()}}
        if cl is not None:
            out['dcond'] = cl.grad
        if pl is not None:
            out['dpitch'] = pl.grad
        results.append(out)
    return results


def _assert_bf16_train_agrees(kernel, plain16, plain32):
    """z and the logdet to the bf16 bar; every gradient within 3e-2
    (norm-relative) of the f32 plain version and no further from the bf16
    plain version than twice that one's distance from the f32 one, plus
    1e-4."""
    assert set(kernel) == set(plain16) == set(plain32)
    for key in ('z', 'ld'):
        err, bar = _bf16_err(kernel[key], plain16[key], plain32[key])
        assert err <= bar, (key, err, bar)
    for key in kernel:
        if key in ('z', 'ld') or plain32[key].norm() == 0:
            continue
        assert torch.isfinite(kernel[key]).all(), key
        to_f32 = _norm_rel(kernel[key], plain32[key])
        own = _norm_rel(plain16[key], plain32[key])
        to_bf16 = _norm_rel(kernel[key], plain16[key])
        assert to_f32 < 3e-2, (key, to_f32)
        assert to_bf16 <= 2 * own + 1e-4, (key, to_bf16, own)


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('lengths', [[1], [33, 1, 16, 33], [200, 1, 130]])
def test_bf16_train_kernels_match_plain(device, lengths, rate):
    before = tg.flow_stack_train.backward_bf16_launches
    kernel, plain16, plain32 = _train_bf16(device, lengths, rate)
    assert tg.flow_stack_train.backward_bf16_launches == before + 2 * 22
    assert kernel['z'].dtype == torch.float32
    _assert_bf16_train_agrees(kernel, plain16, plain32)


@pytest.mark.parametrize('conditioning', ['cond', 'pitch'])
def test_bf16_train_kernels_with_conditioning(device, conditioning):
    before = tg.flow_stack_train.forward_bf16_pitch_launches
    results = _train_bf16(device, [70, 35, 1, 70], 0.05,
                          with_cond=conditioning == 'cond',
                          with_pitch=conditioning == 'pitch')
    assert (tg.flow_stack_train.forward_bf16_pitch_launches > before) == (
        conditioning == 'pitch')
    _assert_bf16_train_agrees(*results)


@pytest.mark.parametrize('lengths', [[70, 35, 1, 70], [512, 33, 1]])
def test_bf16_c80_train_kernels_match_plain(device, lengths):
    before = tg.flow_stack_train.forward_bf16_c80_launches
    results = _train_bf16(device, lengths, 0.05, c=80)
    assert tg.flow_stack_train.forward_bf16_c80_launches == before + 2
    _assert_bf16_train_agrees(*results)


def test_bf16_train_routes_are_bit_equal(device):
    """The stored and the recomputed route give the same bits at bf16, and
    the bf16 backward takes one product (passes 1) alone."""
    store = _train_bf16(device, [200, 1, 130], 0.05, with_cond=True,
                        route='store')
    recompute = _train_bf16(device, [200, 1, 130], 0.05, with_cond=True,
                            route='recompute')
    for key in store[0]:
        assert torch.equal(store[0][key], recompute[0][key]), key
    _assert_bf16_train_agrees(*store)
    with pytest.raises(RuntimeError, match='backward kernel launch failed'):
        _train_bf16(device, [33, 1], 0.0, route='store', passes=3)


def test_bf16_builds_report_their_width_and_refuse_other_routes(device):
    for channels in (160, 80):
        for load in (tc.load_flow_step_library,
                     tg.load_train_forward_library,
                     tg.load_train_backward_library):
            assert load(channels=channels, bf16=True).glow_flow_channels() \
                == channels
    for load in (tc.load_coupling_library, tc.load_flow_stack_library):
        for channels in (160, 80):
            assert load(channels=channels, bf16=True).glow_flow_channels() \
                == channels
    gen = torch.Generator().manual_seed(0)
    w, cond = _weights(gen, device)
    x = torch.randn((4, 8, 160), generator=gen).to(device, torch.bfloat16)
    mask = torch.ones((4, 8, 1), device=device)
    # no route refuses bf16 any more: the coupling (#2) and the stack (#4)
    # take it on their bf16 builds and agree with their plain versions
    w16 = _bf16_pack(w)
    z_b, _ = tc.coupling(x[..., :80], x[..., 80:], mask, w16, cond)
    ref16, _ = tc.coupling_reference(x[..., :80], x[..., 80:], mask, w, cond)
    ref32, _ = tc.coupling_reference(x[..., :80].float(), x[..., 80:].float(),
                                     mask, w, cond)
    assert z_b.dtype == torch.bfloat16
    err, bar = _bf16_err(z_b, ref16, ref32)
    assert err <= bar, (err, bar)
    stacked = {key: v[None] for key, v in w16.items()}
    z, _ = tc.flow_stack(x, mask, stacked, cond[None])
    z_step, _ = tc.flow_step(x, mask, w16, cond)
    torch.cuda.synchronize()
    assert z.dtype == torch.bfloat16 and torch.equal(z, z_step)
    # the f32 layout is refused by the bf16 builds (the flow step's takes
    # the ring body's slices)
    with pytest.raises(ValueError, match='ring'):
        tc.flow_step(x, mask, w, cond)
    with pytest.raises(ValueError, match='ring'):
        tc.coupling(x[..., :80], x[..., 80:], mask, w, cond)


def test_build_defines_of_the_existing_builds_are_unchanged():
    """The macros, and so the libraries' names and hashes, of every build
    that existed before the pitch operand's width followed the flow width
    are what they were; the 80-channel pitch builds are ``GLOW_PITCH``
    beside ``GLOW_CHANNELS=80``, whose pitch operand is 1 wide by default
    (runs on the CPU: no card needed)."""
    assert tc.build_defines() == ()
    assert tc.build_defines(160, True) == ('GLOW_PITCH',)
    assert tc.build_defines(80) == ('GLOW_CHANNELS=80',)
    assert tc.build_defines(160, False, True) == ('GLOW_BF16',)
    assert tc.build_defines(160, True, True) == ('GLOW_PITCH', 'GLOW_BF16')
    assert tc.build_defines(80, False, True) == ('GLOW_CHANNELS=80',
                                                 'GLOW_BF16')
    assert tc.build_defines(80, True) == ('GLOW_PITCH', 'GLOW_CHANNELS=80')
    assert tc.build_defines(80, True, True) == (
        'GLOW_PITCH', 'GLOW_CHANNELS=80', 'GLOW_BF16')
    # the pitch operand is num_squeeze wide, as the JAX package squeezes it
    # (the shipped YAML's 2, MiniSpeech's 1), whatever the flow width; the
    # train kernels take any width that divides the channels, in a build
    # of its own where it is not the 160- or 80-channel build's own
    assert (tc.pitch_width(2), tc.pitch_width(1)) == (2, 1)
    for channels, width in ((160, 1), (80, 2)):
        tc.check_train_shape('flow_stack_train', channels, (4, 5, 192, 384),
                             width)
        assert f'GLOW_PITCH_SIZE={width}' in tc.build_defines(channels, width)
    with pytest.raises(ValueError, match='B.2'):
        tc.check_train_shape('flow_stack_train', 160, (4, 5, 192, 384), 3)
    with pytest.raises(ValueError, match='num_squeeze'):
        tc.pitch_width(0)


def _bf16_coupling_problem(gen, lengths, device, c, pitch):
    w, _ = _weights(gen, device, c=c)
    x, mask = _ragged(gen, lengths, device, c=c)
    cond = (torch.randn((4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    p = None
    if pitch:
        w, p = _with_pitch(gen, w, len(lengths), max(lengths), device, c=c)
    return w, x.to(torch.bfloat16), mask, cond, p


@pytest.mark.parametrize('pitch', [False, True])
@pytest.mark.parametrize('c', [160, C80])
@pytest.mark.parametrize('lengths', [[70, 1, 35, 64], [512, 33, 1]])
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_coupling_matches_plain(device, lengths, reverse, c, pitch,
                                     planted_nan):
    """#2's bf16 build (160 and 80 channels, the pitch builds: 2 wide at
    160, 1 wide at 80) against its bf16 plain version with the f32 plain
    version as the reference, its halves views of one bfloat16 tensor;
    exact zeros past the lengths; one launch counted on its own build."""
    gen = torch.Generator().manual_seed(300 + c + len(lengths) + pitch)
    w, x, mask, cond, p = _bf16_coupling_problem(gen, lengths, device, c,
                                                 pitch)
    half = c // 2
    x_a, x_b = x[..., :half], x[..., half:]
    name = '_'.join(part for part in ('bf16', tc.build_tag(c, pitch),
                                      'launches') if part)
    before = getattr(tc.coupling, name)
    z_b, ld = tc.coupling(x_a, x_b, mask, tc.with_kernel_weights(
        w, torch.bfloat16), cond, pitch=p, reverse=reverse)
    torch.cuda.synchronize()
    assert getattr(tc.coupling, name) == before + 1
    assert z_b.dtype == torch.bfloat16 and torch.isfinite(z_b.float()).all()
    z16, ld16 = tc.coupling_reference(x_a, x_b, mask, w, cond, p, reverse)
    z32, ld32 = tc.coupling_reference(x_a.float(), x_b.float(), mask, w,
                                      cond, p, reverse)
    err, bar = _bf16_err(z_b, z16, z32)
    assert err <= bar, (err, bar)
    assert (z_b[mask.expand_as(z_b) == 0] == 0).all()
    if not reverse:
        err, bar = _bf16_err(ld, ld16, ld32)
        assert err <= bar, (err, bar)


@pytest.mark.parametrize('pitch', [False, True])
@pytest.mark.parametrize('c', [160, C80])
@pytest.mark.parametrize('case', range(len(RAGGED_STACKS)))
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_flow_stack_is_the_bf16_chain_bit_for_bit(device, case,
                                                       reverse, c, pitch,
                                                       planted_nan):
    """#4's bf16 build over 12 steps on ragged masks (with holes, a sample
    of length 0) bit for bit against 12 launches of #3's bf16 build (the
    stream bfloat16 between the steps in both), and against the bf16 plain
    version with the f32 plain version as the reference."""
    lengths, holes = RAGGED_STACKS[case]
    t, steps = 512, 12
    gen = torch.Generator().manual_seed(320 + case + c + pitch)
    w = _stack_weights(gen, device, steps=steps, c=c)
    del w['b_in']
    p = None
    if pitch:
        w, p = _with_pitch(gen, w, len(lengths), t, device, steps=steps, c=c)
    w16 = _bf16_pack(w)
    mask = _ragged_mask(lengths, holes, t, device)
    x = (torch.randn((len(lengths), t, c), generator=gen) * 3).to(
        device, torch.bfloat16)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    z, ld = tc.flow_stack(x, mask, w16, cond, pitch=p, reverse=reverse)
    chain, lds = x, []
    for s in (reversed(range(steps)) if reverse else range(steps)):
        chain, step_ld = tc.flow_step(
            chain, mask, {key: value[s] for key, value in w16.items()},
            cond[s].contiguous(), reverse, pitch=p)
        lds.append(step_ld)
    z16, ld16 = tc.flow_stack_reference(x, mask, w, cond, p, reverse)
    z32, ld32 = tc.flow_stack_reference(x.float(), mask, w, cond, p,
                                        reverse)
    torch.cuda.synchronize()
    assert z.dtype == torch.bfloat16 and torch.isfinite(z.float()).all()
    assert torch.equal(z, chain)
    assert (z[mask[..., 0] == 0] == 0).all()
    err, bar = _bf16_err(z, z16, z32)
    assert err <= bar, (err, bar)
    if not reverse:
        assert _rel(ld, torch.stack(lds).sum(dim=0)) < 1e-5
        err, bar = _bf16_err(ld, ld16, ld32)
        assert err <= bar, (err, bar)


@pytest.mark.parametrize('reverse', [False, True])
def test_c80_pitch_deterministic_kernels_match_plain(device, reverse,
                                                     planted_nan):
    """The pitch operand 1 wide at 80 channels in #3, #2 and #4 at f32:
    each against its plain version, #4 bit for bit against the chain of #3
    launches; each counted on its ``c80_pitch`` build."""
    gen = torch.Generator().manual_seed(340 + reverse)
    lengths, t, steps = [70, 1, 35, 64], 70, 3
    w = _stack_weights(gen, device, steps=steps, c=C80)
    del w['b_in']
    w, p = _with_pitch(gen, w, len(lengths), t, device, steps=steps, c=C80)
    w = tc.with_tensor_core_weights(w)
    x, mask = _ragged(gen, lengths, device, c=C80)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    counts = [fn.c80_pitch_launches for fn in (tc.flow_step, tc.coupling,
                                               tc.flow_stack)]
    z, ld = tc.flow_stack(x, mask, w, cond, pitch=p, reverse=reverse)
    z_chain, ld_chain = _chain_with_pitch(x, mask, w, cond, p, reverse)
    z_ref, ld_ref = tc.flow_stack_reference(x, mask, w, cond, p, reverse)
    step = {key: value[0] for key, value in w.items()}
    own = {key: step[key] for key in (*tc.COUPLING_WEIGHT_KEYS,
                                      *tc.TC_KEYS.values(), 'w_pitch')}
    z_b, _ = tc.coupling(x[..., :40], x[..., 40:], mask, own,
                         cond[0].contiguous(), pitch=p, reverse=reverse)
    zb_ref, _ = tc.coupling_reference(x[..., :40], x[..., 40:], mask, own,
                                      cond[0], p, reverse)
    torch.cuda.synchronize()
    assert [fn.c80_pitch_launches for fn in (
        tc.flow_step, tc.coupling, tc.flow_stack)] == [
            counts[0] + steps, counts[1] + 1, counts[2] + 1]
    assert torch.equal(z, z_chain) and _rel(z, z_ref) < REL
    assert _rel(z_b, zb_ref) < REL
    if not reverse:
        assert _rel(ld, ld_ref) < REL and _rel(ld, ld_chain) < 1e-5


def _chain_with_pitch(x, mask, w, cond, pitch, reverse):
    steps = w['w_in'].shape[0]
    lds = []
    for s in (reversed(range(steps)) if reverse else range(steps)):
        x, ld = tc.flow_step(x, mask, {key: value[s]
                                       for key, value in w.items()},
                             cond[s].contiguous(), reverse, pitch=pitch)
        lds.append(ld)
    return x, (None if reverse else torch.stack(lds).sum(dim=0))


def test_bf16_c80_pitch_kernels_match_plain(device):
    """The pitch operand 1 wide at 80 channels in the bf16 builds: #3
    against its bf16 plain version, and the train pair (#5, #6) with every
    gradient, ``dpitch`` included, to the bf16 bars."""
    gen = torch.Generator().manual_seed(350)
    w, cond = _weights(gen, device, c=C80)
    x, mask = _ragged(gen, [70, 1, 35, 64], device, c=C80)
    w, p = _with_pitch(gen, w, 4, 70, device, c=C80)
    x16 = x.to(torch.bfloat16)
    before = tc.flow_step.bf16_c80_pitch_launches
    for reverse in (False, True):
        z, _ = tc.flow_step(x16, mask, _bf16_pack(w), cond, reverse, pitch=p)
        z16, _ = tc.flow_step_reference(x16, mask, w, cond, reverse, p)
        z32, _ = tc.flow_step_reference(x16.float(), mask, w, cond, reverse,
                                        p)
        err, bar = _bf16_err(z, z16, z32)
        assert err <= bar, (reverse, err, bar)
    torch.cuda.synchronize()
    assert tc.flow_step.bf16_c80_pitch_launches == before + 2
    before = tg.flow_stack_train.forward_bf16_c80_pitch_launches
    results = _train_bf16(device, [70, 35, 1, 70], 0.05, with_cond=True,
                          with_pitch=True, c=C80)
    assert tg.flow_stack_train.forward_bf16_c80_pitch_launches == before + 2
    _assert_bf16_train_agrees(*results)


@pytest.mark.parametrize('build', ['c160', 'c80', 'pitch', 'width1'])
def test_bf16_train_redesign_at_each_build(device, build):
    """#5 and #6 bf16 (bf16 tiles in shared memory; #6's dgrads on wgmma,
    its wgrads on ldmatrix.trans) at each build on a ragged batch with a
    sample of length 1 and a full one: to the bf16 bars against the plain
    versions, the stored and recomputed routes bit-equal, two runs
    bit-equal, and #6's launches 22 a flow step (26 with pitch)."""
    c = C80 if build in ('c80', 'width1') else 160
    pitch = build in ('pitch', 'width1')
    tag = '_'.join(part for part in ('bf16', 'c80' if c == C80 else '',
                                     'pitch' if pitch else '') if part)
    counter = f'backward_{tag}_launches'
    lengths = [130, 1, 57, 130, 96]
    before = getattr(tg.flow_stack_train, counter)
    store = _train_bf16(device, lengths, 0.05, with_cond=True,
                        with_pitch=pitch, c=c, route='store')
    per_step = 26 if pitch else 22
    assert getattr(tg.flow_stack_train, counter) == before + 2 * per_step
    _assert_bf16_train_agrees(*store)
    again = _train_bf16(device, lengths, 0.05, with_cond=True,
                        with_pitch=pitch, c=c, route='store')
    recompute = _train_bf16(device, lengths, 0.05, with_cond=True,
                            with_pitch=pitch, c=c, route='recompute')
    for key in store[0]:
        assert torch.equal(store[0][key], again[0][key]), key
        assert torch.equal(store[0][key], recompute[0][key]), key


@pytest.mark.parametrize('route', ['store', 'recompute'])
def test_bf16_train_gradients_ignore_rows_left_unwritten(device, planted_nan,
                                                         route):
    """At bf16 the backward's epilogues leave the cotangents' rows past a
    sample's length unwritten (nothing reads them) and every buffer here
    starts as NaN: the gradients stay finite, to the bf16 bars, with
    conditioning and a sample of length 1."""
    results = _train_bf16(device, [150, 70, 1, 140], 0.05, with_cond=True,
                          route=route)
    _assert_bf16_train_agrees(*results)


# the ring body's builds (csrc/flow_ring.cuh): flow channels, pitch operand
RING_BUILDS = [(160, False), (160, True), (C80, False), (C80, True)]


def _coupling_pack(step):
    """The coupling's share of a flow step's pack, as the ``'modules'``
    route hands it over."""
    return {key: step[key] for key in tc.COUPLING_PACK_KEYS if key in step}


def _nan_padded_halves(x, half):
    """``x [B, T, C]``'s two halves as views of a wider bfloat16 tensor
    whose other 16 columns are NaN (its rows 16 bytes apart)."""
    b, t, c = x.shape
    wide = torch.full((b, t, c + 16), float('nan'), dtype=x.dtype,
                      device=x.device)
    wide[..., :c] = x
    return wide[..., :half], wide[..., half:c]


def _ring_problem(gen, device, lengths, t, c, pitch, steps=12):
    """Stacked weights of ``steps`` flow steps with the ring body's slices,
    conditioning rows, a pitch operand or None, bfloat16 x on the ragged
    mask (zero past each length) and the mask."""
    w = _stack_weights(gen, device, steps=steps, c=c)
    del w['b_in']
    p = None
    if pitch:
        w, p = _with_pitch(gen, w, len(lengths), t, device, steps=steps, c=c)
    w16 = _bf16_pack(w)
    mask = _ragged_mask(lengths, {}, t, device)
    x = (torch.randn((len(lengths), t, c), generator=gen) * 3).to(device)
    cond = (torch.randn((steps, 4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    return w, w16, cond, p, (x * mask).to(torch.bfloat16), mask


@pytest.mark.parametrize('c,pitch', RING_BUILDS)
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_ring_body_ignores_what_lies_past_each_length(device, c, pitch,
                                                           reverse,
                                                           planted_nan):
    """#3's, #4's and #2's bf16 ring body on a ragged B = 33 with T = 333
    (not a multiple of its 48-frame tile): two runs bit-equal; x planted
    with NaN past each sample's length (the live tiles' tails and the dead
    tiles) gives z and the logdet bit for bit as x with zeros there, zeros
    past each length; #4 bit for bit against 12 launches of #3, and all
    three to the bar against their bf16 plain versions.  #2's halves are
    views of a wider tensor whose other columns are NaN, and give what
    halves of their own give."""
    gen = torch.Generator().manual_seed(400 + c + 2 * pitch + reverse)
    t = 333
    lengths = torch.linspace(1, t, 33).round().long().tolist()
    lengths[5] = 47
    w, w16, cond, p, x, mask = _ring_problem(gen, device, lengths, t, c,
                                             pitch)
    planted = x.masked_fill(mask == 0, float('nan'))
    step = {key: value[0] for key, value in w16.items()}
    z, ld = tc.flow_step(x, mask, step, cond[0].contiguous(), reverse,
                         pitch=p)
    again, ld_again = tc.flow_step(x, mask, step, cond[0].contiguous(),
                                   reverse, pitch=p)
    nan_z, nan_ld = tc.flow_step(planted, mask, step, cond[0].contiguous(),
                                 reverse, pitch=p)
    stack, stack_ld = tc.flow_stack(x, mask, w16, cond, pitch=p,
                                    reverse=reverse)
    nan_stack, _ = tc.flow_stack(planted, mask, w16, cond, pitch=p,
                                 reverse=reverse)
    chain = x
    for s in (reversed(range(12)) if reverse else range(12)):
        chain, _ = tc.flow_step(chain, mask, {key: value[s] for key, value
                                              in w16.items()},
                                cond[s].contiguous(), reverse, pitch=p)
    plain = {key: value[0] for key, value in w.items()}
    z16, _ = tc.flow_step_reference(x, mask, plain, cond[0], reverse, p)
    z32, _ = tc.flow_step_reference(x.float(), mask, plain, cond[0],
                                    reverse, p)
    s16, _ = tc.flow_stack_reference(x, mask, w, cond, p, reverse)
    s32, _ = tc.flow_stack_reference(x.float(), mask, w, cond, p, reverse)
    # #2 on the halves of x, of planted x and of x's own copies
    half = c // 2
    own = _coupling_pack(step)
    z_b, ld_b = tc.coupling(*_nan_padded_halves(x, half), mask, own,
                            cond[0].contiguous(), pitch=p, reverse=reverse)
    nan_b, nan_ld_b = tc.coupling(*_nan_padded_halves(planted, half), mask,
                                  own, cond[0].contiguous(), pitch=p,
                                  reverse=reverse)
    apart, _ = tc.coupling(x[..., :half].contiguous(),
                           x[..., half:].contiguous(), mask, own,
                           cond[0].contiguous(), pitch=p, reverse=reverse)
    b16, _ = tc.coupling_reference(x[..., :half], x[..., half:], mask, plain,
                                   cond[0], p, reverse)
    b32, _ = tc.coupling_reference(x[..., :half].float(),
                                   x[..., half:].float(), mask, plain,
                                   cond[0], p, reverse)
    torch.cuda.synchronize()
    for got in (again, nan_z):
        assert torch.equal(got, z)
    assert torch.equal(nan_stack, stack) and torch.equal(stack, chain)
    assert torch.equal(nan_b, z_b) and torch.equal(apart, z_b)
    assert (z[mask[..., 0] == 0] == 0).all()
    assert (stack[mask[..., 0] == 0] == 0).all()
    assert (z_b[mask[..., 0] == 0] == 0).all()
    if not reverse:
        assert torch.equal(ld, ld_again) and torch.equal(ld, nan_ld)
        assert torch.equal(ld_b, nan_ld_b)
    for got, p16, p32 in ((z, z16, z32), (stack, s16, s32),
                          (z_b, b16, b32)):
        err, bar = _bf16_err(got, p16, p32)
        assert err <= bar, (err, bar)


@pytest.mark.parametrize('c,pitch', RING_BUILDS)
@pytest.mark.parametrize('t', [1, 47, 48, 49, 512])
def test_bf16_ring_body_at_batch_one(device, c, pitch, t):
    """B = 1 at tile edges (below, at and above one 48-frame tile, and the
    decode shape's 512), both directions, #4 over 3 steps bit for bit
    against the chain of #3 and both to the bar against their plain
    versions; #2 on the halves of a wider tensor whose other columns are
    NaN, to the bar against its plain version."""
    gen = torch.Generator().manual_seed(450 + t + c + pitch)
    w, w16, cond, p, x, mask = _ring_problem(gen, device, [t], t, c, pitch,
                                             steps=3)
    half = c // 2
    step = {key: value[0] for key, value in w16.items()}
    plain = {key: value[0] for key, value in w.items()}
    for reverse in (False, True):
        z_b, _ = tc.coupling(*_nan_padded_halves(x, half), mask,
                             _coupling_pack(step), cond[0].contiguous(),
                             pitch=p, reverse=reverse)
        b16, _ = tc.coupling_reference(x[..., :half], x[..., half:], mask,
                                       plain, cond[0], p, reverse)
        b32, _ = tc.coupling_reference(x[..., :half].float(),
                                       x[..., half:].float(), mask, plain,
                                       cond[0], p, reverse)
        err, bar = _bf16_err(z_b, b16, b32)
        assert err <= bar, (reverse, err, bar)
        stack, _ = tc.flow_stack(x, mask, w16, cond, pitch=p,
                                 reverse=reverse)
        chain = x
        for s in (reversed(range(3)) if reverse else range(3)):
            chain, _ = tc.flow_step(chain, mask, {key: value[s] for key, value
                                                  in w16.items()},
                                    cond[s].contiguous(), reverse, pitch=p)
        s16, _ = tc.flow_stack_reference(x, mask, w, cond, p, reverse)
        s32, _ = tc.flow_stack_reference(x.float(), mask, w, cond, p,
                                         reverse)
        torch.cuda.synchronize()
        assert torch.equal(stack, chain), reverse
        err, bar = _bf16_err(stack, s16, s32)
        assert err <= bar, (reverse, err, bar)


def test_bf16_ring_timed_instantiation_is_the_kernel(device):
    """The timed instantiation of #3's bf16 build gives the kernel's z and
    logdet bit for bit, uncounted, with a cycle count for every phase of
    every tile it reports."""
    gen = torch.Generator().manual_seed(470)
    lengths = [100, 1, 512, 300]
    w, w16, cond, p, x, mask = _ring_problem(gen, device, lengths, 512, 160,
                                             False, steps=1)
    step = {key: value[0] for key, value in w16.items()}
    for reverse in (False, True):
        z, ld = tc.flow_step(x, mask, step, cond[0].contiguous(), reverse)
        before = tc.flow_step.bf16_launches
        z_t, ld_t, phases = tc.flow_step_phases(x, mask, step,
                                                cond[0].contiguous(), reverse)
        assert tc.flow_step.bf16_launches == before
        assert torch.equal(z, z_t)
        assert reverse or torch.equal(ld, ld_t)
        assert phases['tiles'] == sum(-(-n // tc.RING_TIME_TILE)
                                      for n in lengths)
        assert set(phases['cycles']) == set(tc.RING_PHASES)
        assert all(cycles > 0 for cycles in phases['cycles'].values())
        assert 0.5 < phases['sm_ghz'] < 3.0


@pytest.mark.parametrize('c,pitch', RING_BUILDS)
@pytest.mark.parametrize('lengths', [[512, 512, 512], [1, 47, 333, 512, 0]])
@pytest.mark.parametrize('reverse', [False, True])
def test_bf16_coupling_is_the_flow_step_on_an_identity_actnorm_and_mixing(
        device, c, pitch, lengths, reverse):
    """On an identity ActNorm (logs and bias 0) and mixing (I, zero-padded
    in the ring's slices) with no per-frame logdet constant, #3 bf16's z
    is [x_a, z_b] of #2 bf16 bit for bit, and so are the forward logdets:
    both run the same WaveNet and affine on the ring body.  #2 also
    reports the live tiles of its 48-frame schedule."""
    gen = torch.Generator().manual_seed(480 + c + pitch + len(lengths))
    t = max(lengths)
    w = _stack_weights(gen, device, steps=1, c=c)
    del w['b_in']
    w['an_logs'].zero_()
    w['an_bias'].zero_()
    w['ld_const'].zero_()
    w['mix_t'] = torch.eye(c, device=device)[None]
    p = None
    if pitch:
        w, p = _with_pitch(gen, w, len(lengths), t, device, steps=1, c=c)
    step = {key: value[0] for key, value in _bf16_pack(w).items()}
    mask = _ragged_mask(lengths, {}, t, device)
    x = ((torch.randn((len(lengths), t, c), generator=gen) * 3).to(device)
         * mask).to(torch.bfloat16)
    cond = (torch.randn((4, len(lengths), 384), generator=gen) * .2
            ).to(device)
    half = c // 2
    z, ld = tc.flow_step(x, mask, step, cond, reverse, pitch=p)
    tiles = tc.tile_report(device)
    z_b, ld_b = tc._coupling_kernel(x[..., :half], x[..., half:], mask,
                                    _coupling_pack(step), cond, p, reverse,
                                    tiles=tiles)
    torch.cuda.synchronize()
    assert torch.isfinite(z_b.float()).all()
    assert torch.equal(z[..., half:], z_b)
    assert torch.equal(z[..., :half], x[..., :half])
    if not reverse:
        assert torch.equal(ld, ld_b)
    items = tc.live_tile_schedule(lengths, t, tc.RING_TIME_TILE)
    blocks = min(tc.load_coupling_library(
        pitch, c, True).glow_coupling_resident_blocks(len(lengths)),
        len(items))
    assert dict(zip(tc.TILE_COUNTS, tiles.tolist())) == _expected_report(
        sum(item[2] for item in items), len(items), blocks)
    assert len(items) == len(lengths) * -(-t // tc.RING_TIME_TILE)


def test_bf16_coupling_refuses_a_misaligned_view(device):
    """The bfloat16 coupling reads its halves 16 bytes at a time: a view 4
    elements (8 bytes) off, or rows a multiple of 4 but not of 8 elements
    apart, raises instead of being read."""
    gen = torch.Generator().manual_seed(0)
    w, cond = _weights(gen, device)
    w16 = tc.with_kernel_weights(w, torch.bfloat16)
    mask = torch.ones((4, 8, 1), device=device)
    x = torch.zeros((4, 8, 168), device=device, dtype=torch.bfloat16)
    x_a, x_b = x[..., :80], x[..., 80:160]
    tc.coupling(x_a, x_b, mask, w16, cond)              # a wider parent runs
    with pytest.raises(ValueError, match='aligned to 8'):
        tc.coupling(x[..., 4:84], x_b, mask, w16, cond)
    with pytest.raises(ValueError, match='aligned to 8'):
        tc.coupling(x_a, x[..., 84:164], mask, w16, cond)
    rows = torch.zeros((4, 8, 164), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='aligned to 8'):
        tc.coupling(rows[..., :80], rows[..., 80:160], mask, w16, cond)


def test_bf16_coupling_timed_instantiation_is_the_kernel(device):
    """The timed instantiation of #2's bf16 build gives the kernel's z_b and
    logdet bit for bit, uncounted, with a cycle count for every phase of
    every tile it reports."""
    gen = torch.Generator().manual_seed(490)
    lengths = [100, 1, 512, 300]
    w, w16, cond, p, x, mask = _ring_problem(gen, device, lengths, 512, 160,
                                             False, steps=1)
    own = _coupling_pack({key: value[0] for key, value in w16.items()})
    halves = (x[..., :80], x[..., 80:])
    for reverse in (False, True):
        z_b, ld = tc.coupling(*halves, mask, own, cond[0].contiguous(),
                              reverse=reverse)
        before = tc.coupling.bf16_launches
        z_t, ld_t, phases = tc.coupling_phases(*halves, mask, own,
                                               cond[0].contiguous(),
                                               reverse=reverse)
        assert tc.coupling.bf16_launches == before
        assert torch.equal(z_b, z_t)
        assert reverse or torch.equal(ld, ld_t)
        assert phases['tiles'] == sum(-(-n // tc.RING_TIME_TILE)
                                      for n in lengths)
        assert set(phases['cycles']) == set(tc.COUPLING_PHASES)
        assert all(cycles > 0 for cycles in phases['cycles'].values())
        assert 0.5 < phases['sm_ghz'] < 3.0


def test_f32_convs_ignore_cudnn_tf32(device):
    """Under PyTorch's default flags (cuDNN's TF32 on, the matmuls' off),
    the port's float32 k-tap ``Conv1d`` (the prenet's 5 taps and the
    duration predictor's 3, at the shipped encoder width) with its input
    gradient, the GST and the GE2E encoder at the shipped widths equal the
    same modules on the CPU to 1e-5 of the max-abs; the library's
    ``F.conv1d`` under the same flags misses that bar (TF32), and holds it
    inside ``cudnn_float32``, after which the flags are the caller's
    again."""
    import os

    import torch.nn.functional as F

    from glow_tts_tpu_torch import load_config
    from glow_tts_tpu_torch.models import conditioning as tcond
    from glow_tts_tpu_torch.models.layers import Conv1d
    from glow_tts_tpu_torch.ops.precision import cudnn_float32
    config = load_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs', 'Hyper_Parameters.yaml'))
    gen = torch.Generator().manual_seed(500)

    def randomised(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p.shape[-1] ** -0.5)
        return module

    def rel(got, want):
        return ((got.float().cpu() - want).abs().max()
                / want.abs().max()).item()

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        width = config.encoder.channels
        for k in (5, 3):
            conv = randomised(Conv1d(width, width, k))
            x = torch.randn((8, 200, width), generator=gen)
            cotangent = torch.randn((8, 200, width), generator=gen)
            xc = x.clone().requires_grad_(True)
            want = conv(xc)
            (want * cotangent).sum().backward()
            want = want.detach()
            xd = x.to(device).requires_grad_(True)
            got = conv.to(device)(xd)
            (got * cotangent.to(device)).sum().backward()
            assert rel(got.detach(), want) <= 1e-5, k
            assert rel(xd.grad, xc.grad) <= 1e-5, k

            def library():
                return F.conv1d(x.to(device).transpose(1, 2), conv.weight,
                                conv.bias, padding=k // 2).transpose(1, 2)
            assert rel(library().detach(), want) > 1e-4, k
            with cudnn_float32():
                assert rel(library().detach(), want) <= 1e-5, k
            assert rel(library().detach(), want) > 1e-4, k
        gst = randomised(tcond.GSTProsodyEncoder(config))
        mels = torch.randn((4, 400, config.sound.mel_dim), generator=gen)
        lengths = torch.tensor([400, 333, 64, 1])
        want = gst(mels, lengths)
        assert rel(gst.to(device)(mels.to(device), lengths.to(device)),
                   want) <= 1e-5
        ge2e = randomised(tcond.GE2ESpeakerEncoder(config))
        slices = torch.randn((6, 50, config.sound.mel_dim), generator=gen)
        want = ge2e(slices)
        assert rel(ge2e.to(device)(slices.to(device)), want) <= 1e-5
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --- ROADMAP B.2: #3, #2 and #4 at other decoder shapes ---------------------

# each build: the shape (C, ch, layers, k) and the pitch operand's width
B2_BUILDS = [pytest.param((200, 192, 4, 5), 0, id='c200'),
             pytest.param((200, 192, 4, 5), 2, id='c200_pitch'),
             pytest.param((16, 16, 2, 5), 0, id='c16_ch16_l2_k5'),
             pytest.param((160, 128, 16, 3), 0, id='c160_ch128_l16_k3'),
             # 128-bin mels at Num_Squeeze 2 (the ring's 40-frame tiles),
             # 100-bin mels at Num_Squeeze 1 (C/2 = 2 mod 4), with GR's
             # pitch operand 1 wide, and C = 12 at a narrow WaveNet
             pytest.param((256, 192, 4, 5), 0, id='c256'),
             pytest.param((100, 192, 4, 5), 0, id='c100'),
             pytest.param((100, 192, 4, 5), 1, id='c100_pitch1'),
             pytest.param((12, 16, 2, 3), 0, id='c12_ch16_l2_k3')]
B2_DTYPES = [pytest.param(torch.float32, id='f32'),
             pytest.param(torch.bfloat16, id='bf16')]
B2_LENGTHS = [97, 60, 1, 33]


def _b2_problem(gen, device, shape, ps, steps=3, lengths=B2_LENGTHS):
    """Stacked float32 weights of ``steps`` flow steps at ``shape`` (scaled
    to their fan-in), the conditioning rows [steps, n, B, 2ch], the pitch
    operand (or None), x [B, T, C] and the mask of ``lengths``."""
    c, ch, n, k = shape

    def rnd(*dims, scale=1.):
        return torch.randn((steps, *dims), generator=gen) * scale
    w = {'w_start': rnd(c // 2, ch, scale=(c / 2) ** -.5),
         'b_start': rnd(ch, scale=.1),
         'w_in': rnd(n, k, ch, 2 * ch, scale=(k * ch) ** -.5),
         'w_rs': rnd(n, ch, 2 * ch, scale=ch ** -.5),
         'b_rs': rnd(n, 2 * ch, scale=.1),
         'w_end': rnd(ch, c, scale=.3 * ch ** -.5), 'b_end': rnd(c, scale=.1),
         'an_logs': rnd(c, scale=.05), 'an_bias': rnd(c, scale=.1),
         'mix_t': torch.stack([torch.linalg.qr(torch.randn(
             (c, c), generator=gen))[0] for _ in range(steps)]),
         'ld_const': rnd(scale=.01)}
    w['w_rs'][:, -1, :, :ch] = 0
    w['b_rs'][:, -1, :ch] = 0
    if ps:
        w['w_pitch'] = rnd(n, ps, 2 * ch, scale=.5)
    w = {key: value.to(device).contiguous() for key, value in w.items()}
    x, mask = _ragged(gen, lengths, device, c=c)
    cond = (torch.randn((steps, n, len(lengths), 2 * ch), generator=gen)
            * .2).to(device)
    pitch = (torch.rand((len(lengths), x.shape[1], ps), generator=gen)
             .to(device) if ps else None)
    return w, cond, pitch, x, mask


def _b2_step(w, s):
    return {key: value[s] for key, value in w.items()}


def _b2_bar(kernel, plain, plain32, dtype):
    """(error, bar): at f32 the relative error and REL; at bf16 the
    absolute error and twice the bf16 plain version's from the f32 one."""
    if dtype == torch.float32:
        err = ((kernel - plain).abs().max()
               / plain.abs().max().clamp_min(1e-30)).item()
        return err, REL
    kernel, plain, plain32 = (v.float() for v in (kernel, plain, plain32))
    return ((kernel - plain).abs().max().item(),
            2 * (plain - plain32).abs().max().item() + 1e-6)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('shape,ps', B2_BUILDS)
def test_b2_kernels_match_plain(device, shape, ps, dtype, reverse):
    """#3, #2 and #4 of the build at ``shape`` against their plain
    versions on a ragged batch (a sample of length 1, T not a multiple of
    any tile), at f32 to REL and at bf16 to the bar of twice the bf16 plain
    version's distance from the f32 one."""
    gen = torch.Generator().manual_seed(600 + sum(shape) + ps)
    w, cond, pitch, x, mask = _b2_problem(gen, device, shape, ps)
    c2 = shape[0] // 2
    stacked = tc.with_kernel_weights(w, dtype)
    step = tc.with_kernel_weights(_b2_step(w, 0), dtype)
    own = {key: step[key] for key in tc.COUPLING_PACK_KEYS if key in step}
    xd = x.to(dtype)
    for name, kernel, plain in (
            ('flow_step', lambda at, ws: tc.flow_step(
                xd.to(at), mask, ws, cond[0], reverse, pitch),
             lambda at: tc.flow_step_reference(
                 xd.to(at), mask, _b2_step(w, 0), cond[0], reverse, pitch)),
            ('coupling', lambda at, ws: tc.coupling(
                xd.to(at)[..., :c2], xd.to(at)[..., c2:], mask, ws, cond[0],
                pitch, reverse),
             lambda at: tc.coupling_reference(
                 xd.to(at)[..., :c2], xd.to(at)[..., c2:], mask,
                 _b2_step(w, 0), cond[0], pitch, reverse)),
            ('flow_stack', lambda at, ws: tc.flow_stack(
                xd.to(at), mask, ws, cond, pitch, reverse),
             lambda at: tc.flow_stack_reference(
                 xd.to(at), mask, w, cond, pitch, reverse))):
        weights = (stacked if name == 'flow_stack' else
                   own if name == 'coupling' else step)
        z, ld = kernel(dtype, weights)
        z_p, ld_p = plain(dtype)
        z_32, ld_32 = plain(torch.float32)
        torch.cuda.synchronize()
        assert z.dtype == dtype and torch.isfinite(z.float()).all(), name
        err, bar = _b2_bar(z, z_p, z_32, dtype)
        assert err <= bar, (name, err, bar)
        if not reverse:
            err, bar = _b2_bar(ld, ld_p, ld_32, dtype)
            assert err <= bar, (name, 'logdet', err, bar)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('shape,ps', B2_BUILDS)
def test_b2_stack_is_chained_flow_steps(device, shape, ps, dtype, reverse):
    """#4 of the build is bit for bit the chain of #3 launches of the same
    build, one a flow step (the stream in the build's dtype between
    them)."""
    steps = 3
    gen = torch.Generator().manual_seed(640 + sum(shape) + ps)
    w, cond, pitch, x, mask = _b2_problem(gen, device, shape, ps, steps)
    stacked = tc.with_kernel_weights(w, dtype)
    z, _ = tc.flow_stack(x.to(dtype), mask, stacked, cond, pitch, reverse)
    chained = x.to(dtype)
    for s in (reversed(range(steps)) if reverse else range(steps)):
        chained, _ = tc.flow_step(
            chained, mask, tc.with_kernel_weights(_b2_step(w, s), dtype),
            cond[s], reverse, pitch)
    torch.cuda.synchronize()
    assert (z != chained).sum().item() == 0


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape,ps', B2_BUILDS)
def test_b2_bf16_coupling_is_the_flow_step_on_an_identity(device, shape, ps,
                                                          reverse):
    """On an identity ActNorm and mixing with no per-frame logdet constant,
    #2 bf16's z_b and logdet are #3 bf16's bit for bit at every build, and
    #2 reports the live tiles of its time tile's schedule."""
    gen = torch.Generator().manual_seed(680 + sum(shape) + ps)
    w, cond, pitch, x, mask = _b2_problem(gen, device, shape, ps, steps=1)
    c = shape[0]
    w['an_logs'].zero_()
    w['an_bias'].zero_()
    w['ld_const'].zero_()
    w['mix_t'] = torch.eye(c, device=device)[None]
    step = tc.with_kernel_weights(_b2_step(w, 0), torch.bfloat16)
    own = {key: step[key] for key in tc.COUPLING_PACK_KEYS if key in step}
    x16 = (x * 3).to(torch.bfloat16)
    z, ld = tc.flow_step(x16, mask, step, cond[0], reverse, pitch)
    tiles = tc.tile_report(device)
    z_b, ld_b = tc._coupling_kernel(x16[..., :c // 2], x16[..., c // 2:],
                                    mask, own, cond[0], pitch, reverse,
                                    tiles=tiles)
    torch.cuda.synchronize()
    assert (z[..., c // 2:] != z_b).sum().item() == 0
    assert (z[..., :c // 2] != x16[..., :c // 2]).sum().item() == 0
    if not reverse:
        assert (ld != ld_b).sum().item() == 0
    tile = tc.geometry(tc.FlowShape(*shape), True, ps)['time_tile']
    items = tc.live_tile_schedule(B2_LENGTHS, x.shape[1], tile)
    got = dict(zip(tc.TILE_COUNTS, tiles.tolist()))
    assert (got['live'], got['items']) == (sum(i[2] for i in items),
                                           len(items))


def test_b2_bf16_coupling_reads_the_c200_halves_where_they_lie(device):
    """At C = 200 a bfloat16 half's rows are 200 bytes, not a multiple of
    16: the build reads x_a and x_b 8 bytes at a time, so the decoder's own
    halves of one [B, T, 200] tensor are taken as they lie (and give what
    contiguous copies give), and a view 2 elements off is refused."""
    gen = torch.Generator().manual_seed(700)
    w, cond, _, x, mask = _b2_problem(gen, device, (200, 192, 4, 5), 0,
                                      steps=1)
    own = tc.with_kernel_weights(
        {key: w[key][0] for key in tc.COUPLING_WEIGHT_KEYS}, torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    x_a, x_b = x16[..., :100], x16[..., 100:]
    assert x_b.data_ptr() % 16 == 8
    z_b, ld = tc.coupling(x_a, x_b, mask, own, cond[0])
    z_c, ld_c = tc.coupling(x_a.contiguous(), x_b.contiguous(), mask, own,
                            cond[0])
    torch.cuda.synchronize()
    assert (z_b != z_c).sum().item() == 0 and torch.equal(ld, ld_c)
    wide = torch.zeros((x.shape[0], x.shape[1], 204), device=device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='aligned to 4'):
        tc.coupling(wide[..., 2:102], wide[..., 102:202], mask, own, cond[0])


@pytest.mark.parametrize('dtype', B2_DTYPES)
def test_b2_coupling_reads_the_c100_halves_where_they_lie(device, dtype):
    """At C = 100 a half's rows are 200 bytes at f32 and 100 at bf16: the
    build reads them 8 and 4 bytes at a time, so the decoder's own halves
    of one [B, T, 100] tensor are taken as they lie (x_b starts 8 bytes
    into a 16-byte chunk) and give what contiguous copies give; a view one
    element off a load's alignment is refused."""
    gen = torch.Generator().manual_seed(701)
    w, cond, _, x, mask = _b2_problem(gen, device, (100, 192, 4, 5), 0,
                                      steps=1)
    own = tc.with_kernel_weights(
        {key: w[key][0] for key in tc.COUPLING_WEIGHT_KEYS}, dtype)
    xd = x.to(dtype)
    x_a, x_b = xd[..., :50], xd[..., 50:]
    assert x_b.data_ptr() % 16 == (8 if dtype == torch.float32 else 4)
    z_b, ld = tc.coupling(x_a, x_b, mask, own, cond[0])
    z_c, ld_c = tc.coupling(x_a.contiguous(), x_b.contiguous(), mask, own,
                            cond[0])
    torch.cuda.synchronize()
    assert (z_b != z_c).sum().item() == 0 and torch.equal(ld, ld_c)
    wide = torch.zeros((x.shape[0], x.shape[1], 102), device=device,
                       dtype=dtype)
    with pytest.raises(ValueError, match='aligned to 2'):
        tc.coupling(wide[..., 1:51], wide[..., 51:101], mask, own, cond[0])


@pytest.mark.parametrize('dtype', B2_DTYPES)
def test_b2_train_depth_tail_gradients_at_c100(device, dtype):
    """C = 100: the end conv's and the mixing's activation gradients are
    100 deep (the f32 build's tail instantiations; the bf16 build stages
    the C-wide rows as 8-byte halves) and the start conv's weight gradient
    50 (C/2 = 2 mod 4); dx, dw_start, dmix_t and dw_end hold the bars."""
    kernel, plain, plain32 = _b2_train(device, (100, 192, 4, 5), 0, dtype,
                                       lengths=[200, 1, 130])
    for key in ('dx', 'dw_start', 'dan_logs', 'dmix_t', 'dw_end'):
        assert kernel[key].abs().max() > 0, key
    _assert_b2_train_agrees(kernel, plain, plain32, dtype)


@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('source', ['flow_step.cu', 'coupling.cu',
                                    'flow_stack.cu'])
@pytest.mark.parametrize('shape,ps', B2_BUILDS)
def test_b2_library_geometry_is_pythons(device, shape, ps, source, dtype):
    """Each library reports the geometry it was compiled with, and it is
    ops/coupling.py::geometry's (the loader raises otherwise)."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    shape = tc.FlowShape(*shape)
    bf16 = dtype == torch.bfloat16
    tc.load_flow_library(source, ps, shape, bf16)
    lib = load_library(source, tc.build_defines(shape, ps, bf16))
    got = tc.library_geometry(lib)
    assert got == {**shape._asdict(), 'pitch_size': ps,
                   **{key: value for key, value in
                      tc.geometry(shape, bf16, ps).items()
                      if key in tc.GEOMETRY_FIELDS}}


# --- ROADMAP B.2, the train half: #5 and #6 at other decoder shapes --------

# the B.2 builds, and (C 160, ch 80, 2 layers, k 5): the start conv's
# activation gradient 80 deep, not a multiple of a slice, at a C that is;
# and C = 200 at 8 layers, whose #5 stores without its saving stage
B2_TRAIN_BUILDS = [*B2_BUILDS,
                   pytest.param((160, 80, 2, 5), 0, id='c160_ch80_l2_k5'),
                   pytest.param((200, 192, 8, 5), 0, id='c200_l8')]


def _b2_train(device, shape, ps, dtype, lengths=B2_LENGTHS, rate=0.05,
              route=None, holes=(), seed=700):
    """#5 and #6 of the build at ``shape`` (with a pitch operand ``ps``
    wide, and cond) on a ragged batch of 2 flow steps through
    ``flow_stack_train`` (or the forced ``route``), and the plain version
    at ``dtype`` and at f32: z, the logdet and every gradient of a loss
    through both, each a dict."""
    gen = torch.Generator().manual_seed(seed + sum(shape) + ps)
    w, cond, pitch, x, mask = _b2_problem(gen, device, shape, ps, steps=2,
                                          lengths=lengths)
    c, ch, n, _ = shape
    w['b_in'] = (torch.randn((2, n, 2 * ch), generator=gen) * .1).to(device)
    for sample, first, end in holes:
        mask[sample, first:end] = 0
    x = x * mask
    zt = torch.randn(x.shape, generator=gen).to(device)
    wl = torch.arange(1., x.shape[0] + 1.).to(device)

    def kernels(xl, mask, leaves, cl, pl, seed, dropout_rate):
        return tg._apply_kernels(xl, mask, leaves, cl, seed, dropout_rate,
                                 route, pitch=pl)
    results = []
    for fn, at in ((tg.flow_stack_train if route is None else kernels, dtype),
                   (tg.flow_stack_train_reference, dtype),
                   (tg.flow_stack_train_reference, torch.float32)):
        leaves = {key: v.clone().requires_grad_() for key, v in w.items()}
        xl = x.to(at).detach().clone().requires_grad_()
        cl = cond.clone().requires_grad_()
        pl = None if pitch is None else pitch.clone().requires_grad_()
        z, ld = fn(xl, mask, leaves, cl, pl, seed=-91, dropout_rate=rate)
        (torch.sum(z.float() * zt) + 0.7 * torch.sum(ld * wl)).backward()
        torch.cuda.synchronize()
        out = {'z': z.detach().float(), 'ld': ld.detach(),
               'dx': xl.grad.float(), 'dcond': cl.grad,
               **{f'd{key}': leaf.grad for key, leaf in leaves.items()}}
        if pl is not None:
            out['dpitch'] = pl.grad
        results.append(out)
    return results


def _assert_b2_train_agrees(kernel, plain, plain32, dtype):
    if dtype == torch.bfloat16:
        _assert_bf16_train_agrees(kernel, plain, plain32)
        return
    assert set(kernel) == set(plain)
    for key, value in plain.items():
        assert torch.isfinite(kernel[key]).all(), key
        assert _rel(kernel[key], value) < REL, (key, _rel(kernel[key], value))


@pytest.mark.parametrize('rate', [0.0, 0.05])
@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('shape,ps', B2_TRAIN_BUILDS)
def test_b2_train_kernels_match_plain(device, shape, ps, dtype, rate):
    """#5 and #6 of the build at ``shape`` against the plain version (at
    f32 to REL, at bf16 to the bf16 bars) on a ragged batch with cond (and
    the pitch operand), counted on the build's own counters: 2 forward
    launches and 2 x backward_launches_per_step(n) backward kernels."""
    shape_ = tc.FlowShape(*shape)
    bf16 = dtype == torch.bfloat16
    names = {what: f'{what}_{tc.count_suffix(shape_, ps, bf16)}'
             for what in ('forward', 'recompute', 'backward')}
    before = {what: getattr(tg.flow_stack_train, name, 0)
              for what, name in names.items()}
    results = _b2_train(device, shape, ps, dtype, rate=rate)
    got = {what: getattr(tg.flow_stack_train, name, 0) - before[what]
           for what, name in names.items()}
    assert got == {'forward': 2, 'recompute': 0,
                   'backward': 2 * tg.backward_launches_per_step(
                       shape[2], bool(ps))}, got
    _assert_b2_train_agrees(*results, dtype)


@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('shape,ps', B2_TRAIN_BUILDS)
def test_b2_train_routes_and_runs_are_bit_equal(device, shape, ps, dtype):
    """The stored and the recomputed route, and two runs, give the same
    bits, on a mask with holes and a sample of length 1."""
    holes = [(0, 10, 45), (3, 5, 9)]
    runs = [_b2_train(device, shape, ps, dtype, route=route, holes=holes)[0]
            for route in ('store', 'recompute', 'store')]
    for key in runs[0]:
        assert (runs[0][key] != runs[1][key]).sum().item() == 0, key
        assert (runs[0][key] != runs[2][key]).sum().item() == 0, key


@pytest.mark.parametrize('dtype', B2_DTYPES)
@pytest.mark.parametrize('shape', [(16, 16, 2, 5), (160, 128, 16, 3),
                                   (160, 80, 2, 5)])
def test_b2_train_masks_are_the_true_columns(device, shape, dtype):
    """At a padded WaveNet (ch 16, 128, 80: the body computes at 64, 128,
    128) the forward's dropout masks, read element by element through a
    probe stack whose pre-gate sum is the keep factor itself (w_in = 0,
    b_in = 1: a dropped element leaves tanh 0 and sigmoid 1/2 in the saved
    gate halves), are ``dropmask.stack_mask``'s over the true 2ch, which
    the JAX package draws."""
    from glow_tts_tpu_torch.ops import dropmask
    c, ch, n, k = shape
    gen = torch.Generator().manual_seed(sum(shape))
    w, _, _, x, mask = _b2_problem(gen, device, shape, 0, steps=2)
    w['b_in'] = torch.ones((2, n, 2 * ch), device=device)
    w['w_in'] = torch.zeros_like(w['w_in'])
    b, t = x.shape[:2]
    saved = tg._saved_buffers(b * t, c, ch, n, device, dtype=dtype)
    tg._recompute(x.to(dtype), torch.ones_like(mask), None,
                  tg._kernel_weights([w[key] for key in tg.WEIGHT_KEYS],
                                     dtype),
                  saved, 1, tg._dropout_args(-17, 0.3))
    ts = saved['ts'].float()
    kept = torch.cat([ts[..., :ch] != 0, ts[..., ch:] != 0.5],
                     dim=-1).reshape(n, b, t, 2 * ch)
    want = torch.stack([dropmask.stack_mask(-17, 1, i, n, b, t, k, 2 * ch,
                                            0.3, device) != 0
                        for i in range(n)])
    assert (kept != want).sum().item() == 0


def test_b2_train_depth_tail_gradients_at_ch80(device):
    """(C 160, ch 80): the start conv's activation gradient is 80 deep, and
    only a build with the zero-filling tail instantiations computes it;
    dx (which it reaches) and every gradient hold the f32 bar."""
    kernel, plain, _ = _b2_train(device, (160, 80, 2, 5), 0, torch.float32,
                                 lengths=[200, 1, 130])
    for key in ('dx', 'dw_start', 'dan_logs', 'dmix_t'):
        assert kernel[key].abs().max() > 0, key
    _assert_b2_train_agrees(kernel, plain, None, torch.float32)


def test_b2_train_refuses_what_no_build_takes(device):
    """A bf16 WaveNet whose ch is not a multiple of 8 (20), and a WaveNet
    of more layers than the backward's one reduction launch adds (30 of
    k 1), raise naming B.2's train half before any launch; the f32 build
    takes ch 20."""
    for shape, dtype in (((160, 20, 2, 5), torch.bfloat16),
                         ((8, 4, 30, 1), torch.float32)):
        gen = torch.Generator().manual_seed(3)
        w, cond, _, x, mask = _b2_problem(gen, device, shape, 0, steps=1,
                                          lengths=[9, 4])
        w['b_in'] = torch.zeros((1, shape[2], 2 * shape[1]), device=device)
        before = dict(vars(tg.flow_stack_train))
        with pytest.raises(ValueError, match='B.2, the train half'):
            tg.flow_stack_train(x.to(dtype), mask, w, cond, seed=0)
        assert {key: value for key, value in vars(tg.flow_stack_train).items()
                if key.endswith('launches')} == {
            key: value for key, value in before.items()
            if key.endswith('launches')}
    kernel, plain, _ = _b2_train(device, (160, 20, 2, 5), 0, torch.float32,
                                 lengths=[40, 9])
    _assert_b2_train_agrees(kernel, plain, None, torch.float32)


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('shape,ps', B2_TRAIN_BUILDS)
def test_b2_train_library_geometry_is_pythons(device, shape, ps, bf16):
    """#5's library reports its geometry (the float32 body with the saving
    stage, whether w_pitch is staged), and it is ``geometry(...,
    train=True)``'s; #6's takes the build's layers' reduction jobs."""
    from glow_tts_tpu_torch.ops.cuda_build import load_library
    shape = tc.FlowShape(*shape)
    tg.load_train_forward_library(ps, shape, bf16)
    lib = load_library('flow_train_fwd.cu', tc.build_defines(shape, ps, bf16))
    assert tc.library_geometry(lib) == {
        **shape._asdict(), 'pitch_size': ps,
        **{key: value for key, value in
           tc.geometry(shape, bf16, ps, train=True).items()
           if key in tc.GEOMETRY_FIELDS}}
    bwd = tg.load_train_backward_library(ps, shape, bf16)
    assert bwd.glow_flow_train_bwd_max_reduce() >= 7 + 5 * shape.n_layers
