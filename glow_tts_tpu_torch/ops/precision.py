"""The compute dtypes of the port and the rounding the bf16 policy needs
(``config.compute_dtype``, ``config.inference_dtype``; the JAX package's
per-layer casts, ``glow_tts_tpu/models``).

Where the JAX package computes a product in bfloat16 with float32 sums
(``preferred_element_type=jnp.float32``, or a Pallas kernel's ``dot`` on
operands cast to ``dt``), the port rounds both operands to bfloat16 and
multiplies them in float32: a product of two bfloat16 values is exact in
float32, so the two differ only in the order of the sums.
"""

from __future__ import annotations

import torch

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
