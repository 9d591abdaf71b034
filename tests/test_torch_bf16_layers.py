"""The port's layers and modules at bfloat16 against the JAX package's at
``dtype=bfloat16``, each from the same f32 parameters and inputs: the 1×1
and k-tap convs, the weight-normalised conv's kernel, the LayerNorm, the
relative-position attention, the dropout's scale, the text encoder (with
and without a conditioning vector), the conditioning encoders (the
speaker look-up table, GE2E per slice and pooled, the GST prosody encoder,
the speaker classifier), ActNorm (forward, reverse, its data-dependent
statistics), the invertible 1×1 mixing and the affine coupling (the JAX
module under ``'fused_interpret'``, the fused coupling kernel at bf16).

Tolerance (``tests/torch_port_helpers.py``): max|port − jax_bf16| ≤
2·max|jax_bf16 − jax_f32| + 1e-6, where jax_f32 is the same JAX module at
its default float32.  The port rounds where XLA does (a bf16 product, then
the bias added in bf16), so most results come out bit-equal to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import decoder as jd
from glow_tts_tpu.models import layers as jl
from glow_tts_tpu_torch.models import layers as tl
from glow_tts_tpu_torch.models.decoder import ActNorm
from tests.torch_port_helpers import (assert_bf16_close, at_dtype,
                                      jax_model, norm_rel, port_config,
                                      port_model, ragged, t, with_backend)

BF = jnp.bfloat16


def _both(module_of, params, x):
    """(jax_bf16, jax_f32): ``module_of(dtype).apply`` on ``x``."""
    return tuple(np.asarray(module_of(dtype).apply({'params': params}, x),
                            np.float32) for dtype in (BF, None))


@pytest.mark.parametrize('kernel_size', [1, 3, 5])
def test_conv1d(kernel_size):
    rng = np.random.default_rng(kernel_size)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    params = jl.Conv1d(7, kernel_size).init(jax.random.PRNGKey(0),
                                            jnp.asarray(x))['params']
    inner = params['dense' if kernel_size == 1 else 'conv']
    inner['bias'] = jnp.asarray(rng.standard_normal(7) * .3, jnp.float32)
    j16, j32 = _both(lambda dt: jl.Conv1d(7, kernel_size, dtype=dt), params,
                     jnp.asarray(x))
    port = tl.Conv1d(6, 7, kernel_size)
    tl.set_compute_dtype(port, torch.bfloat16)
    kernel = np.asarray(inner['kernel'])
    if kernel_size == 1:
        kernel = kernel[None]
    with torch.no_grad():
        port.weight.copy_(t(kernel.transpose(2, 1, 0)))
        port.bias.copy_(t(inner['bias']))
    out = port(t(x))
    assert out.dtype == torch.bfloat16
    assert_bf16_close(out, j16, j32)


def test_wnconv1d_kernel_in_bf16():
    """The weight norm's kernel in float32, cast to bfloat16 where it is
    used: the port's effective weight rounded is JAX's bf16 kernel."""
    rng = np.random.default_rng(1)
    module = jl.WNConv1d(8, 5, dtype=BF)
    x = jnp.asarray(rng.standard_normal((1, 4, 6)), jnp.float32)
    params = module.init(jax.random.PRNGKey(1), x)['params']
    params = {'v': params['v'], 'b': params['b'],
              'g': params['g'] * (1.0 + rng.random(8).astype(np.float32))}
    kernel, _ = module.apply({'params': params}, x, return_params=True)
    port = tl.WNConv1d(6, 8, 5)
    with torch.no_grad():
        port.weight_v.copy_(t(np.asarray(params['v']).transpose(2, 1, 0)))
        port.weight_g.copy_(t(np.asarray(params['g'])[:, None, None]))
    with torch.no_grad():
        eff = port.effective_weight()
    assert eff.dtype == torch.float32
    ref = np.asarray(jnp.asarray(kernel).astype(BF).astype(jnp.float32))
    got = eff.to(torch.bfloat16).float().numpy().transpose(2, 1, 0)
    # the f32 norms agree to an ulp, so the bf16 kernels are equal but
    # where a value sits on a rounding boundary
    assert (got == ref).mean() > 0.99
    np.testing.assert_allclose(got, ref, rtol=2 ** -7)
    # and the bf16 conv of the JAX module is the bf16 product of that kernel
    out = np.asarray(module.apply({'params': params}, x), np.float32)
    j32 = np.asarray(jl.WNConv1d(8, 5).apply({'params': params}, x))
    conv = tl.Conv1d(6, 8, 5)
    tl.set_compute_dtype(conv, torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(eff)
        conv.bias.copy_(t(params['b']))
    assert_bf16_close(conv(t(np.asarray(x))), out, j32)


def test_layer_norm_keeps_f32_statistics():
    x = (np.random.default_rng(2).standard_normal((2, 5, 16)) * 3 + 1
         ).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, 16).astype(np.float32)
    params = {'LayerNorm_0': {'scale': scale, 'bias': bias}}
    xb = jnp.asarray(x, BF)
    j16 = np.asarray(jl.LayerNorm(dtype=BF).apply({'params': params}, xb),
                     np.float32)
    j32 = np.asarray(jl.LayerNorm().apply({'params': params},
                                          jnp.asarray(x)))
    port = tl.LayerNorm(16)
    tl.set_compute_dtype(port, torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(t(scale))
        port.bias.copy_(t(bias))
    out = port(t(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert_bf16_close(out, j16, j32)


def test_relative_attention():
    rng = np.random.default_rng(3)
    b, length, c, heads, window = 3, 7, 16, 2, 2
    x, mask = ragged(rng, b, length, c, [7, 4, 1])
    x = np.asarray(jnp.asarray(x, BF).astype(jnp.float32))
    m = mask[..., 0]
    attn_mask = jnp.asarray(m[:, None, :, None] * m[:, None, None, :])

    def module(dtype):
        return jl.RelativePositionMultiHeadAttention(
            calc_channels=c, out_channels=c, num_heads=heads,
            window_size=window, dtype=dtype)

    params = module(None).init(jax.random.PRNGKey(2), jnp.asarray(x),
                               mask=attn_mask)['params']
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    (o16, a16), (o32, a32) = (
        module(dt).apply({'params': params}, jnp.asarray(x, xdt),
                         mask=attn_mask)
        for dt, xdt in ((BF, BF), (None, jnp.float32)))
    port = tl.RelativePositionMultiHeadAttention(c, heads, window)
    tl.set_compute_dtype(port, torch.bfloat16)
    with torch.no_grad():
        for name, key in [('Query', 'query'), ('Key', 'key'),
                          ('Value', 'value'), ('Projection', 'proj')]:
            layer = port.layer_Dict[name]
            kernel = np.asarray(params[key]['kernel'])
            layer.weight.copy_(t(kernel.T[..., None]))
            layer.bias.copy_(t(params[key]['bias']))
        port.weight_K.copy_(t(params['rel_emb_k']))
        port.weight_V.copy_(t(params['rel_emb_v']))
    out, align = port(t(x).to(torch.bfloat16), t(np.asarray(attn_mask)))
    assert out.dtype == torch.bfloat16 and align.dtype == torch.float32
    assert_bf16_close(align, np.asarray(a16), np.asarray(a32), 'alignments')
    assert_bf16_close(out, np.asarray(o16, np.float32), np.asarray(o32),
                      'output')


@pytest.mark.parametrize('rate', [0.1, 0.5, 0.05])
def test_dropout_scale_is_in_the_input_dtype(rate):
    """FastDropout's scale is ``jnp.asarray(1 / (1 - rate), x.dtype)``: the
    kept elements are ``x * bf16(scale)`` rounded to bf16, the others 0."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 50, 8), generator=gen).to(torch.bfloat16)
    out = tl.Dropout(rate)(x, False, gen)
    scale = np.asarray(jnp.asarray(1.0 / (1.0 - rate), BF), np.float32)
    kept = out != 0
    expected = np.asarray(jnp.asarray(x.float().numpy(), BF) * jnp.asarray(
        scale, BF), np.float32)
    assert out.dtype == torch.bfloat16
    assert 0.5 * (1 - rate) < kept.float().mean() < 1.5 * (1 - rate)
    np.testing.assert_array_equal(out.float().numpy()[kept.numpy()],
                                  expected[kept.numpy()])


@pytest.fixture(scope='module', params=['Vanilla', 'GR', 'SE-GE2E'])
def models(request):
    """One JAX model in a mode, as (cfg, model at f32, model at bf16,
    params, batch, port model at bf16)."""
    cfg, _, params, batch = jax_model(seed=3, mode=request.param)
    from glow_tts_tpu.training.step import build_model
    port = port_model(cfg, params)
    port.set_compute_dtype(torch.bfloat16)
    return (cfg, build_model(cfg), build_model(at_dtype(cfg, 'bfloat16')),
            params, batch, port)


def _apply(model, params, method, *args):
    out = model.apply({'params': params}, *args, method=method)
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), out)


def test_text_encoder(models):
    cfg, m32, m16, params, batch, port = models
    tokens, lengths = batch['tokens'], batch['token_lengths']
    mask = np.asarray(jl.sequence_mask(jnp.asarray(lengths), tokens.shape[1]))
    cond = None
    if cfg.condition_size:
        cond = np.random.default_rng(4).standard_normal(
            (len(lengths), cfg.condition_size)).astype(np.float32)
    args = (jnp.asarray(tokens), jnp.asarray(mask),
            None if cond is None else jnp.asarray(cond), True)
    refs = [_apply(m, params, lambda mod, *a: mod.encoder(*a), *args)
            for m in (m16, m32)]
    with torch.no_grad():
        out = port.layer_Dict['Encoder'](
            t(tokens).long(), t(mask), None if cond is None else t(cond))
    for name, got, j16, j32 in zip(('mean', 'log_std', 'log_durations'),
                                   out, *refs):
        assert got.dtype == torch.bfloat16, name
        assert_bf16_close(got, j16, j32, name)


def test_conditioning_encoders(models):
    cfg, m32, m16, params, batch, port = models
    rng = np.random.default_rng(5)
    b = 3
    if not cfg.uses_speaker_embedding and not cfg.uses_prosody_encoder:
        # Vanilla: no conditioning encoder, on either side
        assert not {'LUT', 'GE2E', 'Prosody_Encoder'} & set(port.layer_Dict)
        return
    if cfg.speaker_embedding.type.upper() == 'GE2E' and \
            cfg.uses_speaker_embedding:
        inference = cfg.speaker_embedding.ge2e.inference
        slices = rng.standard_normal(
            (b * inference.samples, inference.slice_length,
             cfg.sound.mel_dim)).astype(np.float32)
        for method, port_fn in (
                (lambda m, x: m.ge2e(x), port.layer_Dict['GE2E']),
                (lambda m, x: m.ge2e.embed_utterances(x),
                 port.layer_Dict['GE2E'].embed_utterances)):
            j16, j32 = (_apply(m, params, method, slices) for m in (m16, m32))
            with torch.no_grad():
                got = port_fn(t(slices))
            assert got.dtype == torch.bfloat16
            assert_bf16_close(got, j16, j32, 'ge2e')
        return
    ids = np.array([3, 0, 2], np.int32)
    j16, j32 = (_apply(m, params, lambda mod, s: mod.speaker_lut(s), ids)
                for m in (m16, m32))
    got = port.layer_Dict['LUT'](t(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), j16)
    if not cfg.uses_prosody_encoder:
        return
    lengths = np.array([40, 37, 9], np.int32)
    mels = rng.standard_normal((b, 40, cfg.sound.mel_dim)).astype(np.float32)
    mels[np.arange(40)[None, :] >= lengths[:, None]] = -4.0
    j16, j32 = (_apply(m, params, lambda mod, x, n: mod.prosody_encoder(x, n),
                       mels, lengths) for m in (m16, m32))
    with torch.no_grad():
        prosody = port.layer_Dict['Prosody_Encoder'](t(mels),
                                                     t(lengths).long())
    assert prosody.dtype == torch.bfloat16
    assert_bf16_close(prosody, j16, j32, 'gst')
    # the classifier has no dtype in the JAX package: float32 at bf16 too
    j16, j32 = (_apply(m, params, lambda mod, p: mod.speaker_classifier(p),
                       prosody.float().numpy()) for m in (m16, m32))
    with torch.no_grad():
        got = port.layer_Dict['Speaker_Classifier_GR'](prosody)
    assert got.dtype == torch.float32
    assert_bf16_close(got, j16, j32, 'classifier')


@pytest.mark.parametrize('reverse', [False, True])
def test_actnorm_and_mixing(models, reverse):
    cfg, m32, m16, params, batch, port = models
    c = cfg.sound.mel_dim * cfg.decoder.num_squeeze
    rng = np.random.default_rng(6)
    x, mask = ragged(rng, 3, 9, c, [9, 6, 3])
    x = np.asarray(jnp.asarray(x, BF).astype(jnp.float32))
    step = port.layer_Dict['Decoder'].layer_Dict['Flows'][1]
    for name, key, module in (
            ('actnorm', 0, lambda dt: jd.ActNorm(dt)),
            ('invconv', 1, lambda dt: jd.InvertibleConv(
                cfg.decoder.num_split, dt))):
        variables = {'params': params['decoder']['flow_1'][name]}
        (z16, _), (z32, _) = (
            module(dt).apply(variables, jnp.asarray(x, xdt),
                             jnp.asarray(mask), reverse=reverse)
            for dt, xdt in ((BF, BF), (None, jnp.float32)))
        layer = step.layers[key]
        with torch.no_grad():
            if key == 0:
                got, _ = layer(t(x).to(torch.bfloat16), t(mask), reverse)
            else:
                got, _ = layer(t(x).to(torch.bfloat16), t(mask), reverse,
                               (layer.mixing_matrix(reverse).t(),
                                layer.frame_logdet(c)))
        assert got.dtype == torch.bfloat16, name
        assert_bf16_close(got, np.asarray(z16, np.float32), np.asarray(z32),
                          name)


def test_actnorm_init_statistics_on_bf16_input():
    """The data-dependent statistics are float32 of a bfloat16 input, as
    the JAX ActNorm's initialisers compute them."""
    rng = np.random.default_rng(7)
    x, mask = ragged(rng, 3, 11, 16, [11, 6, 2])
    xb = jnp.asarray(x * 2.0 + 0.5, BF)
    ref = jd.ActNorm(BF).init(jax.random.PRNGKey(0), xb,
                              jnp.asarray(mask))['params']
    port = ActNorm(16)
    port.data_dependent_init(t(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16), t(mask))
    np.testing.assert_allclose(port.logs.reshape(-1).detach().numpy(),
                               np.asarray(ref['logs']), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.bias.reshape(-1).detach().numpy(),
                               np.asarray(ref['bias']), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('reverse', [False, True])
def test_affine_coupling(models, reverse):
    """The port's coupling module (its plain version on the CPU) against the
    JAX AffineCoupling under ``'fused_interpret'`` (the fused coupling
    kernel at the module's dtype), both with the in-conv bias rows."""
    cfg, m32, m16, params, batch, port = models
    c = cfg.sound.mel_dim * cfg.decoder.num_squeeze
    rng = np.random.default_rng(8)
    x, mask = ragged(rng, 3, 9, c, [9, 6, 3])
    x = np.asarray(jnp.asarray(x, BF).astype(jnp.float32))
    fused = with_backend(cfg, 'fused_interpret')
    variables = {'params': params['decoder']['flow_0']['coupling']}
    (z16, _), (z32, _) = (
        jd.AffineCoupling(fused, dt).apply(
            variables, jnp.asarray(x, xdt), jnp.asarray(mask),
            reverse=reverse)
        for dt, xdt in ((BF, BF), (None, jnp.float32)))
    if cfg.uses_speaker_embedding or cfg.uses_prosody_encoder:
        return   # the JAX module's rows would need the conditioning vectors
    coupling = port.layer_Dict['Decoder'].layer_Dict['Flows'][0].layers[2]
    with torch.no_grad():
        got, _ = coupling(t(x).to(torch.bfloat16), t(mask), reverse)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, np.asarray(z16, np.float32), np.asarray(z32))


def test_compute_dtype_is_an_attribute_not_a_parameter(models):
    """One state dict serves both dtypes: switching the dtype moves no
    parameter and adds none."""
    cfg, m32, m16, params, batch, port = models
    before = {key: value.clone() for key, value in port.state_dict().items()}
    port.set_compute_dtype(torch.float32)
    assert port.layer_Dict['Encoder'].dtype == torch.float32
    port.set_compute_dtype('bfloat16')
    assert port.layer_Dict['Encoder'].dtype == torch.bfloat16
    after = port.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[key], before[key]) for key in before)
    assert all(value.dtype == torch.float32 for key, value in after.items()
               if value.is_floating_point())
    if 'Speaker_Classifier_GR' in port.layer_Dict:
        hidden = port.layer_Dict['Speaker_Classifier_GR'].layer['Hidden_0']
        assert hidden.dtype == torch.float32
    assert dataclasses.replace(port_config(cfg),
                               compute_dtype='bfloat16').compute_dtype \
        == 'bfloat16'


@pytest.mark.parametrize('route', ['modules', 'mega', 'fused'])
def test_routes_without_a_bf16_build_raise(route):
    """No route lacks a bf16 build any more (``'modules'``: #2, ``'mega'``:
    #4, ``'fused'``: #3), so none raises: at bf16 each route's
    deterministic forward and its inverse compute, through the wrappers
    (the plain versions here), what the route's plain functions passed by
    hand compute, bit for bit; ``'mega'`` is bit-equal to ``'fused'`` (a
    loop of the same plain step), and ``'modules'`` (the JAX package's
    flax route: the stream in the input's dtype between the modules,
    another bf16 policy, held against JAX's in
    ``tests/test_torch_bf16_routes.py``) is, like every route, within 3e-2
    norm-relative of the f32 forward.
    Training runs under every route (the train kernels have bf16
    builds)."""
    from glow_tts_tpu_torch.models.glow_tts import random_state_dict
    from glow_tts_tpu_torch.ops.coupling import (coupling_reference,
                                                 flow_stack_reference,
                                                 flow_step_reference)
    from glow_tts_tpu_torch.training.step import build_model
    cfg, _, _, batch = jax_model(seed=4)
    args = [t(batch[key]) for key in ('tokens', 'token_lengths', 'mels',
                                      'mel_lengths')]
    plain = {'step_fn': flow_step_reference,
             'coupling_fn': coupling_reference,
             'flow_stack_fn': flow_stack_reference}
    outs = {}
    for r, dtype in ((route, 'bfloat16'), ('fused', 'bfloat16'),
                     ('fused', 'float32')):
        pcfg = dataclasses.replace(port_config(cfg), coupling_backend=r,
                                   compute_dtype=dtype)
        model = build_model(pcfg)
        model.load_state_dict(random_state_dict(pcfg, 0))
        model.prepare(fold=False)
        decoder = model.layer_Dict['Decoder']
        mask = (torch.arange(args[2].shape[1])[None, :]
                < args[3][:, None])[..., None].float()
        with torch.no_grad():
            z, logdet, _ = decoder(args[2], mask)
            z_plain, logdet_plain, _ = decoder(args[2], mask, **plain)
            back, _, _ = decoder(z, mask, reverse=True)
        outs[(r, dtype)] = (z, logdet, back)
        assert torch.equal(z, z_plain) and torch.equal(logdet, logdet_plain)
        assert z.dtype == back.dtype == torch.float32
        assert torch.isfinite(z).all() and torch.isfinite(back).all()
        if dtype == 'bfloat16' and r == route:
            out = model(*args, deterministic=False, seed=0,
                        generator=torch.Generator().manual_seed(0))
            assert out['z'].dtype == torch.float32
            assert torch.isfinite(out['z']).all()
    got, fused, f32 = (outs[key] for key in ((route, 'bfloat16'),
                                             ('fused', 'bfloat16'),
                                             ('fused', 'float32')))
    for name, a, b, c in zip(('z', 'logdet', 'inverse'), got, fused, f32):
        assert norm_rel(a, c) < 3e-2, name
        if route != 'modules':
            assert torch.equal(a, b), name
