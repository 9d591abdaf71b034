"""The compute dtypes of the port and the rounding the bf16 policy needs
(``config.compute_dtype``, ``config.inference_dtype``; the JAX package's
per-layer casts, ``glow_tts_tpu/models``).

Where the JAX package computes a product in bfloat16 with float32 sums
(``preferred_element_type=jnp.float32``, or a Pallas kernel's ``dot`` on
operands cast to ``dt``), the port rounds both operands to bfloat16 and
multiplies them in float32: a product of two bfloat16 values is exact in
float32, so the two differ only in the order of the sums.

At float32 the JAX package computes its convolutions in float32, while
cuDNN computes float32 convolutions and RNNs in TF32 under PyTorch's
default flags (``torch.backends.cudnn.allow_tf32`` True).
:func:`cudnn_float32` switches that off for a block and gives the
caller's flags back after it, and :func:`conv_float32` is a convolution
whose forward and backward both run inside it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``'float32'`` or ``'bfloat16'`` (a config's dtype field) as a torch
    dtype; a torch dtype passes as it is."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f'the port computes at {tuple(DTYPES)}, got '
                         f'{name!r} (ROADMAP.md A.5)')
    return DTYPES[name]


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (to nearest even, as ``astype`` rounds)
    and held in float32; ``x`` as it is at float32.  Autograd rounds the
    gradient the same way on its way back."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).float()


def rounded_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight rounded to ``dtype`` in the forward pass whose gradient
    passes unrounded (float32 weight gradients, as the port's train kernels
    sum them)."""
    if dtype == torch.float32:
        return w
    return w + (w.to(dtype).float() - w).detach()


@contextlib.contextmanager
def cudnn_float32():
    """cuDNN's float32 convolutions and RNNs in float32, not TF32, inside
    the block, whatever the caller's flags say; the caller's flags back
    after it.  Through ``torch.backends.cudnn.{conv,rnn}.fp32_precision``
    (PyTorch 2.9 on), which read and write consistently whichever API
    the caller set (the legacy ``allow_tf32`` getter raises on a mix)."""
    scopes = (torch.backends.cudnn.conv, torch.backends.cudnn.rnn)
    saved = [scope.fp32_precision for scope in scopes]
    for scope in scopes:
        scope.fp32_precision = 'ieee'
    try:
        yield
    finally:
        for scope, value in zip(scopes, saved):
            scope.fp32_precision = value


class _ConvFloat32(torch.autograd.Function):
    """A convolution (1-D or 2-D by the weight's rank) whose forward and
    backward both run in :func:`cudnn_float32`: autograd's own backward
    of ``F.conv1d`` would run outside any scope of the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, bias is not None)
        conv = F.conv1d if weight.dim() == 3 else F.conv2d
        with cudnn_float32():
            return conv(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias = ctx.conv
        one_d = weight.dim() == 3
        grad_x = grad_w = grad_b = None
        with cudnn_float32():
            if ctx.needs_input_grad[0]:
                grad_x = (torch.nn.grad.conv1d_input if one_d else
                          torch.nn.grad.conv2d_input)(
                    x.shape, weight, grad, stride, padding)
            if ctx.needs_input_grad[1]:
                grad_w = (torch.nn.grad.conv1d_weight if one_d else
                          torch.nn.grad.conv2d_weight)(
                    x, weight.shape, grad, stride, padding)
        if has_bias and ctx.needs_input_grad[2]:
            grad_b = grad.sum(dim=(0, *range(2, grad.dim())))
        return grad_x, grad_w, grad_b, None, None


def conv_float32(x: torch.Tensor, weight: torch.Tensor,
                 bias=None, stride=1, padding=0) -> torch.Tensor:
    """``F.conv1d`` / ``F.conv2d`` (by the weight's rank) of float32
    operands computed in float32 on a card, forward and backward, whatever
    cuDNN's TF32 flags say (:func:`cudnn_float32`)."""
    return _ConvFloat32.apply(x, weight, bias, stride, padding)
