"""The float32 convolutions and recurrences of the PyTorch port's encoder,
duration predictor and conditioning, as the port computes them at
float32 without cuDNN's TF32 (which cuDNN takes on a card under PyTorch's
default flags): the k-tap ``Conv1d`` and the GST's ``Conv2d`` stack
through ``ops.precision.conv_float32`` (forward and backward inside
``cudnn_float32``), the GST GRU as written-out steps, the GE2E LSTM as
cuDNN's inside ``cudnn_float32``.  Against the JAX package's modules on
the same numpy inputs, on the CPU:

* ``Conv1d`` at 3 and 5 taps (the duration predictor's and the prenet's),
  forward and the gradients of the input, the kernel and the bias, rtol =
  atol = 1e-5;
* the GST prosody encoder's gradient of the reference mels, ragged
  lengths, 1e-5;
* ``conv_float32`` against torch's own ``F.conv1d``/``F.conv2d`` (float32
  on the CPU), value and gradients, at every conv of the GST's stack and
  a strided 1-D one with and without a bias;
* ``cudnn_float32`` sets cuDNN's conv and RNN float32 precision to
  ``'ieee'`` inside and gives back the caller's flags, also a mix of the
  two flag APIs and after a raise (that the card then takes no TF32 is
  the card test's reading).

The card's reading under PyTorch's default flags is
``tests/test_torch_cuda.py::test_f32_convs_ignore_cudnn_tf32``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from glow_tts_tpu.models import layers as jlayers
from glow_tts_tpu_torch.models.layers import Conv1d
from glow_tts_tpu_torch.ops.precision import conv_float32, cudnn_float32
from tests.torch_port_helpers import jax_model, port_model, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('k', [3, 5])
def test_conv1d_matches_jax_forward_and_backward(k):
    rng = np.random.default_rng(k)
    b, length, c_in, c_out = 3, 17, 12, 10
    x = rng.standard_normal((b, length, c_in)).astype(np.float32)
    kernel = (rng.standard_normal((k, c_in, c_out)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    cotangent = rng.standard_normal((b, length, c_out)).astype(np.float32)

    module = jlayers.Conv1d(c_out, k)
    params = {'conv': {'kernel': jnp.asarray(kernel),
                       'bias': jnp.asarray(bias)}}

    def loss(params, x):
        y = module.apply({'params': params}, x)
        return jnp.sum(y * cotangent), y

    (_, ref), (grad_params, grad_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    conv = Conv1d(c_in, c_out, k)
    with torch.no_grad():
        conv.weight.copy_(t(kernel).permute(2, 1, 0))
        conv.bias.copy_(t(bias))
    xt = t(x).requires_grad_(True)
    y = conv(xt)
    (y * t(cotangent)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_x), **TOL)
    np.testing.assert_allclose(
        conv.weight.grad.permute(2, 1, 0).numpy(),
        np.asarray(grad_params['conv']['kernel']), **TOL)
    np.testing.assert_allclose(conv.bias.grad.numpy(),
                               np.asarray(grad_params['conv']['bias']),
                               **TOL)


@pytest.fixture(scope='module')
def gr():
    cfg, model, params, _ = jax_model(seed=21, mode='GR')
    return cfg, model, params, port_model(cfg, params)


@pytest.mark.parametrize('lengths', [[40, 37, 9, 1], [16, 15, 40, 3]])
def test_gst_gradient_matches_jax(gr, lengths):
    cfg, model, params, port = gr
    rng = np.random.default_rng(sum(lengths) + 1)
    mels = rng.standard_normal((len(lengths), 40, cfg.sound.mel_dim)
                               ).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    mels[np.arange(40)[None, :] >= lengths[:, None]] = -4.0
    cotangent = rng.standard_normal(
        (len(lengths), cfg.prosody_encoder.size)).astype(np.float32)

    def loss(x):
        y = model.apply({'params': params}, x, jnp.asarray(lengths),
                        method=lambda m, x, n: m.prosody_encoder(x, n))
        return jnp.sum(y * cotangent)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(mels)))
    xt = t(mels).requires_grad_(True)
    got = port.layer_Dict['Prosody_Encoder'](xt, t(lengths).long())
    (got * t(cotangent)).sum().backward()
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)


def _against_library(fn, library, x, params, seed):
    """``fn`` and ``library`` on ``x`` with the gradients of ``x`` and of
    ``params`` under one random cotangent: equal to 1e-5."""
    outs = []
    for f in (fn, library):
        for p in params:
            p.grad = None
        xi = x.clone().requires_grad_(True)
        y = f(xi)
        cotangent = torch.randn(y.shape,
                                generator=torch.Generator().manual_seed(seed))
        (y * cotangent).sum().backward()
        outs.append((y.detach(), xi.grad, *(p.grad.clone() for p in params)))
    for got, want in zip(*outs):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **TOL)
    return outs[1][0]


def test_conv_float32_is_the_library_conv(gr):
    """Each conv of the GST's stack on its own input, then a strided 1-D
    conv with a bias and one without."""
    _, _, _, port = gr
    encoder = port.layer_Dict['Prosody_Encoder']
    rng = np.random.default_rng(7)
    x = t(rng.standard_normal((2, 1, 20, 33)).astype(np.float32))
    for i in range(len(encoder.strides)):
        conv = encoder.layer_Dict[f'Conv_{i}'].Conv
        y = _against_library(
            lambda v: conv_float32(v, conv.weight, None, conv.stride,
                                   conv.padding),
            lambda v: F.conv2d(v, conv.weight, None, conv.stride,
                               conv.padding), x, [conv.weight], i)
        x = F.relu(y)
    weight = t(rng.standard_normal((6, 4, 3)).astype(np.float32))
    bias = t(rng.standard_normal(6).astype(np.float32))
    weight.requires_grad_(True)
    bias.requires_grad_(True)
    x = t(rng.standard_normal((3, 4, 19)).astype(np.float32))
    for b, params in ((bias, [weight, bias]), (None, [weight])):
        _against_library(lambda v: conv_float32(v, weight, b, 2, 1),
                         lambda v: F.conv1d(v, weight, b, 2, 1), x, params,
                         10)


def _flags():
    cudnn = torch.backends.cudnn
    return (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)


@pytest.mark.parametrize('caller', ['default', 'off', 'mixed'])
def test_cudnn_float32_restores_the_callers_flags(caller):
    cudnn = torch.backends.cudnn
    saved = _flags()
    try:
        if caller == 'off':
            cudnn.allow_tf32 = False
        elif caller == 'mixed':
            cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = (
                'tf32', 'ieee')
        before = _flags()
        with cudnn_float32():
            assert _flags() == ('ieee', 'ieee')
        assert _flags() == before
        with pytest.raises(KeyError):
            with cudnn_float32():
                raise KeyError('inside')
        assert _flags() == before
    finally:
        cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = saved
