"""The CUDA kernels against their plain PyTorch versions on the card.

The flow step at the shipped width (C=160, ch=192, 4 layers, k=5), where
the time tiles and their halos meet the sequence edges: T below, at and
just above one tile, ragged lengths including 1.  MAS at small and edge
shapes (every tokens-per-lane instantiation, T_tok not a multiple of 32,
odd T_mel, more tokens than frames), equal bit for bit, and a raise beyond
the kernel's limits.  Needs a GPU and nvcc; skipped without.

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from glow_tts_tpu_torch.ops import coupling as tc
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
    return ({key: v.to(device).contiguous() for key, v in w.items()},
            cond.to(device))


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
    limit = tm.load_mas_library().glow_mas_max_mel_frames(1024)
    with pytest.raises(ValueError, match=f'at most {limit} mel frames'):
        tm.maximum_path(torch.zeros((1, 1024, limit + 1), device=device),
                        tl[:1], ml[:1])
    # at the limit it runs
    big = torch.zeros((1, 1024, limit), device=device)
    _check_mas(big, tl[:1], ml[:1])
