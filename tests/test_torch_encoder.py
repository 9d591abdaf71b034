"""The PyTorch port's layers, relative-position attention and text encoder
against the JAX package on the same parameters and inputs (f32, CPU;
tolerance rtol = atol = 1e-5, summation-order noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import layers as jl
from glow_tts_tpu.ops import attention as ja
from glow_tts_tpu_torch.models import layers as tl
from glow_tts_tpu_torch.ops import attention as ta
from tests.torch_port_helpers import jax_model, port_model, ragged, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_sequence_mask_and_masked():
    lengths = np.array([5, 1, 3], np.int32)
    ref = jl.sequence_mask(jnp.asarray(lengths), 6)
    port = tl.sequence_mask(t(lengths), 6)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    x = np.random.default_rng(0).standard_normal((3, 6, 4)).astype(np.float32)
    _close(tl.masked(t(x), port), jl.masked(jnp.asarray(x), ref))


@pytest.mark.parametrize('kernel_size', [1, 3, 5])
def test_conv1d(kernel_size):
    rng = np.random.default_rng(kernel_size)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    module = jl.Conv1d(7, kernel_size)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    ref = module.apply({'params': params}, jnp.asarray(x))
    port = tl.Conv1d(6, 7, kernel_size)
    inner = params['dense' if kernel_size == 1 else 'conv']
    kernel = np.asarray(inner['kernel'])
    if kernel_size == 1:
        kernel = kernel[None]
    with torch.no_grad():
        port.weight.copy_(t(kernel.transpose(2, 1, 0)))
        port.bias.copy_(t(np.asarray(inner['bias']) + 0.1))
    ref = ref + 0.1
    _close(port(t(x)), ref)


def test_wnconv1d_effective_weight():
    rng = np.random.default_rng(1)
    module = jl.WNConv1d(8, 5)
    x = jnp.asarray(rng.standard_normal((1, 4, 6)), jnp.float32)
    params = module.init(jax.random.PRNGKey(1), x)['params']
    params = {'v': params['v'], 'b': params['b'],
              'g': params['g'] * (1.0 + rng.random(8).astype(np.float32))}
    kernel, _ = module.apply({'params': params}, x, return_params=True)
    port = tl.WNConv1d(6, 8, 5)
    with torch.no_grad():
        port.weight_v.copy_(t(np.asarray(params['v']).transpose(2, 1, 0)))
        port.weight_g.copy_(t(np.asarray(params['g'])[:, None, None]))
    _close(port.effective_weight(), np.asarray(kernel).transpose(2, 1, 0))


def test_layer_norm():
    x = np.random.default_rng(2).standard_normal((2, 5, 16)) * 3 + 1
    x = x.astype(np.float32)
    module = jl.LayerNorm()
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, 16).astype(np.float32)
    params = {'LayerNorm_0': {'scale': scale, 'bias': bias}}
    ref = module.apply({'params': params}, jnp.asarray(x))
    port = torch.nn.LayerNorm(16, eps=1e-4)
    with torch.no_grad():
        port.weight.copy_(t(scale))
        port.bias.copy_(t(bias))
    _close(port(t(x)), ref)


@pytest.mark.parametrize('length', [2, 3, 9])
def test_relative_tables(length):
    emb = np.random.default_rng(length).standard_normal((1, 5, 3))
    emb = emb.astype(np.float32)
    rel_ref = ja.clip_relative_embedding(jnp.asarray(emb), length)
    rel = ta.clip_relative_embedding(t(emb), length)
    np.testing.assert_array_equal(rel.numpy(), np.asarray(rel_ref))
    np.testing.assert_array_equal(
        ta.skewed_relative_table(rel, length).numpy(),
        np.asarray(ja.skewed_relative_table(rel_ref, length)))


@pytest.mark.parametrize('length', [1, 9, 64])
def test_relative_table_gradient_is_the_same_every_run(length):
    """The skew table's gradient against ``jax.vjp`` of the JAX one, and
    bit-equal over repeated runs with other allocations in between (an
    index gather's backward accumulated in a varying order at 64)."""
    rng = np.random.default_rng(length)
    emb = rng.standard_normal((1, 5, 8)).astype(np.float32)
    cot = rng.standard_normal((1, length, length, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda e: ja.skewed_relative_table(
        ja.clip_relative_embedding(e, length), length), jnp.asarray(emb))
    ref = vjp(jnp.asarray(cot))[0]

    def grad():
        leaf = t(emb).requires_grad_()
        table = ta.skewed_relative_table(
            ta.clip_relative_embedding(leaf, length), length)
        (table * t(cot)).sum().backward()
        return leaf.grad

    first, held = grad(), []
    _close(first, ref)
    for i in range(20):
        held.append(torch.empty(7 * i + 1))
        assert torch.equal(grad(), first), i


def test_embedding_is_the_library_lookup():
    """The encoder's ``Embedding``: the values of ``nn.Embedding`` and its
    weight gradient (a product with the one-hot tokens), repeated tokens
    summed, unused rows zero."""
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 12, (3, 40), generator=gen, dtype=torch.int32)
    tokens[:, -5:] = 1
    grad = torch.randn((3, 40, 6), generator=gen)
    ours, ref = tl.Embedding(15, 6), torch.nn.Embedding(15, 6)
    with torch.no_grad():
        ref.weight.copy_(ours.weight)
    out, out_ref = ours(tokens), ref(tokens.long())
    assert torch.equal(out, out_ref)
    (out * grad).sum().backward()
    (out_ref * grad).sum().backward()
    torch.testing.assert_close(ours.weight.grad, ref.weight.grad,
                               rtol=1e-6, atol=1e-6)
    assert (ours.weight.grad[12:] == 0).all()


@pytest.mark.parametrize('skew_table', [True, False])
def test_relative_attention(skew_table, monkeypatch):
    """The port's skew-table formulation against both JAX formulations
    (the skew table, the default, and the rel↔abs shuffles)."""
    monkeypatch.setattr(jl, '_ATTN_SKEW_TABLE', skew_table)
    rng = np.random.default_rng(3)
    b, length, c, heads, window = 3, 7, 16, 2, 2
    x, mask = ragged(rng, b, length, c, [7, 4, 1])
    m = mask[..., 0]
    attn_mask = m[:, None, :, None] * m[:, None, None, :]
    module = jl.RelativePositionMultiHeadAttention(
        calc_channels=c, out_channels=c, num_heads=heads, window_size=window)
    params = module.init(jax.random.PRNGKey(2), jnp.asarray(x),
                         mask=jnp.asarray(attn_mask))['params']
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    out_ref, align_ref = module.apply({'params': params}, jnp.asarray(x),
                                      mask=jnp.asarray(attn_mask))

    port = tl.RelativePositionMultiHeadAttention(c, heads, window)
    with torch.no_grad():
        for name, key in [('Query', 'query'), ('Key', 'key'),
                          ('Value', 'value'), ('Projection', 'proj')]:
            layer = port.layer_Dict[name]
            kernel = np.asarray(params[key]['kernel'])
            layer.weight.copy_(t(kernel.T[..., None]))
            layer.bias.copy_(t(params[key]['bias']))
        port.weight_K.copy_(t(params['rel_emb_k']))
        port.weight_V.copy_(t(params['rel_emb_v']))
    out, align = port(t(x), t(attn_mask))
    _close(align, align_ref)
    _close(out, out_ref)


@pytest.fixture(scope='module')
def models():
    cfg, model, params, batch = jax_model(seed=1)
    return cfg, model, params, batch, port_model(cfg, params)


def test_text_encoder(models):
    cfg, model, params, batch, port = models
    tokens, lengths = batch['tokens'], batch['token_lengths']
    mask = np.asarray(jl.sequence_mask(jnp.asarray(lengths), tokens.shape[1]))
    ref = model.apply({'params': params}, jnp.asarray(tokens),
                      jnp.asarray(mask), None, True,
                      method=lambda m, *a: m.encoder(*a))
    with torch.no_grad():
        out = port.layer_Dict['Encoder'](t(tokens).long(), t(mask))
    for name, port_value, ref_value in zip(
            ('mean', 'log_std', 'log_durations'), out, ref):
        np.testing.assert_allclose(port_value.numpy(), np.asarray(ref_value),
                                   err_msg=name, **TOL)
