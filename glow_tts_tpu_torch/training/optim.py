"""Optimiser and learning-rate schedule of the train step (port of
``glow_tts_tpu/training/optim.py``).

One update is the JAX package's optax chain, in its order:

1. clip by global norm (``Train.Gradient_Norm``): gradients are scaled by
   ``max_norm / norm`` when ``norm >= max_norm``;
2. Rectified Adam with the reference's arithmetic: float32 moments, the
   ``N_sma >= 5`` switch between the rectified ``m / (√v + eps)`` update
   and the bias-corrected momentum-only update, eps added to the
   *uncorrected* ``√v``;
3. decoupled weight decay, ``+ wd · p``;
4. ``× −lr`` with the warmup-free Noam decay ``initial · base^½ ·
   (step + base)^−½``, whose step counts from 0 and is clamped to ≥ 1 (so
   the first two updates share a rate);
5. the alignment curriculum's decoder freeze: a zero update for the frozen
   parameters (:meth:`RAdam.step`'s ``frozen``).

Everything runs as ``torch._foreach_*`` passes over the parameter list; the
scalars that depend on the step count alone are computed on the host in
float32, as the JAX package computes them, and the one scalar that depends
on the gradients (their global norm) stays on the device, so a step never
waits for the card.  Under tensor parallelism (``parallel/tp.py``) a
sharded parameter's moments are its shard's (the update is elementwise),
and the clipping norm takes each sharded tensor's norm over the model
group.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from glow_tts_tpu_torch.parallel.tp import Shard, reduce_from_model, shard_dims

F32 = np.float32


def modified_noam_schedule(initial: float, base: int
                           ) -> Callable[[int], float]:
    """``schedule(count)``: the rate applied at schedule count ``count``
    (0 for the first update), float32 arithmetic."""
    def schedule(count: int) -> float:
        step = max(F32(count), F32(1.0))
        return float(F32(initial * base ** 0.5) * (step + F32(base))
                     ** F32(-0.5))
    return schedule


def learning_rate_at(config, step: int) -> float:
    """The rate applied at optimiser step ``step`` (0-based)."""
    rate = config.train.learning_rate
    return modified_noam_schedule(rate.initial, rate.base)(step)


def global_norm(tensors: List[torch.Tensor],
                shards: Optional[Sequence[Optional[Shard]]] = None
                ) -> torch.Tensor:
    """√Σ‖t‖² over the list, a 0-d tensor on their device.  The tensors'
    norms are summed in the order of their values, not of the list, so an
    optimiser over the same parameters in another order clips by the same
    bits (a restored run continues the saved one bit for bit).  A tensor
    with a :class:`~glow_tts_tpu_torch.parallel.tp.Shard` in ``shards`` is
    a slice of one sharded over a model group: its norm is the square root
    of its squared slice norms summed over the group (one all-reduce of
    all of them), the whole tensor's norm."""
    norms = torch.stack(torch._foreach_norm(tensors))
    sharded = [i for i, shard in enumerate(shards or ()) if shard is not None]
    if sharded:
        index = torch.tensor(sharded, device=norms.device)
        squares = reduce_from_model(norms[index] ** 2,
                                    shards[sharded[0]].world)
        norms = norms.index_copy(0, index, squares.sqrt())
    return torch.linalg.vector_norm(torch.sort(norms).values)


class RAdam:
    """Clip → RAdam → weight decay → Noam rate over ``params``, updated in
    place by :meth:`step` from their ``.grad``.  A parameter that requires
    no gradient is frozen and not the optimiser's: no update, no weight
    decay, no moments, and no part of the clipping norm (the JAX package's
    ``frozen`` label, which holds the pre-trained GE2E encoder,
    ``GlowTTS`` sets it so)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], *,
                 learning_rate: float, base: int, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.0, max_grad_norm: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = modified_noam_schedule(learning_rate, base)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def rectification(self, t: int):
        """(use the rectified update, its factor, the plain factor) at the
        ``t``-th update, ``t`` from 1."""
        b1, b2, t = self.beta1, self.beta2, F32(t)
        beta2_t = F32(b2) ** t
        n_sma_max = F32(2.0 / (1.0 - b2) - 1.0)
        n_sma = n_sma_max - F32(2.0) * t * beta2_t / (F32(1.0) - beta2_t)
        rect = np.sqrt(np.maximum(
            (F32(1.0) - beta2_t) * (n_sma - F32(4.0)) / (n_sma_max - F32(4.0))
            * (n_sma - F32(2.0)) / n_sma * n_sma_max / (n_sma_max - F32(2.0)),
            F32(0.0)))
        bias1 = F32(1.0) - F32(b1) ** t
        return bool(n_sma >= 5.0), float(rect / bias1), float(F32(1.0) / bias1)

    @torch.no_grad()
    def step(self, frozen: Iterable[torch.nn.Parameter] = ()
             ) -> torch.Tensor:
        """One update from the parameters' gradients (a missing gradient
        counts as zero).  The parameters of ``frozen`` (the decoder, while
        the alignment curriculum freezes it) get a zero update, weight
        decay included, but their gradients still count in the clipping
        norm and still move their moments, as the JAX package zeroes the
        optax chain's updates: zeroing the gradients instead leaves the
        second moments empty, and the first update after the release an
        oversized sign step.  Returns the gradients' global norm before
        clipping, a 0-d tensor on the device."""
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                 for p in params]
        norm = global_norm(grads, shard_dims(params))
        # g / norm * max where norm >= max, else g / 1 * 1: exact either way
        within = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        grads = torch._foreach_div(grads, torch.where(within, one, norm))
        torch._foreach_mul_(grads, torch.where(
            within, one, one * self.max_grad_norm))

        self.count += 1
        torch._foreach_mul_(self.mu, self.beta1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.beta1)
        torch._foreach_mul_(self.nu, self.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads,
                                value=1.0 - self.beta2)

        rectified, step_rect, step_plain = self.rectification(self.count)
        if rectified:
            updates = torch._foreach_mul(self.mu, step_rect)
            denom = torch._foreach_sqrt(self.nu)
            torch._foreach_add_(denom, self.epsilon)
            torch._foreach_div_(updates, denom)
        else:
            updates = torch._foreach_mul(self.mu, step_plain)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -self.schedule(self.count - 1))
        held = {id(p) for p in frozen}
        if held:
            moving = [i for i, p in enumerate(params) if id(p) not in held]
            params = [params[i] for i in moving]
            updates = [updates[i] for i in moving]
        torch._foreach_add_(params, updates)
        return norm


    def _names(self, model: torch.nn.Module) -> List[str]:
        """Each parameter's name in ``model``, in this optimiser's order."""
        names = {id(p): name for name, p in model.named_parameters()}
        missing = [i for i, p in enumerate(self.params) if id(p) not in names]
        if missing:
            raise ValueError(f'{len(missing)} parameters of the optimiser '
                             f'are not in the model')
        return [names[id(p)] for p in self.params]

    def state_dict(self, model: torch.nn.Module) -> Dict[str, object]:
        """``count`` and the moments ``mu``/``nu`` keyed by each
        parameter's name in ``model``, as copies on the CPU."""
        names = self._names(model)

        def by_name(tensors):
            return {name: t.detach().to('cpu', copy=True)
                    for name, t in zip(names, tensors)}
        return {'count': self.count, 'mu': by_name(self.mu),
                'nu': by_name(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object],
                        model: torch.nn.Module) -> None:
        """Restore what :meth:`state_dict` returned, onto the moments'
        own device, matched by name in ``model``."""
        names = self._names(model)
        for key in ('mu', 'nu'):
            if set(state[key]) != set(names):
                raise KeyError(f'optimiser state {key!r} does not hold the '
                               f'model\'s parameters: '
                               f'{sorted(set(state[key]) ^ set(names))[:4]}')
            for name, t in zip(names, getattr(self, key)):
                t.copy_(state[key][name])
        self.count = int(state['count'])


def make_optimizer(config, params: Iterable[torch.nn.Parameter]) -> RAdam:
    """The optimiser of ``config.train`` over ``params``."""
    train = config.train
    return RAdam(params, learning_rate=train.learning_rate.initial,
                 base=train.learning_rate.base, beta1=train.adam.beta1,
                 beta2=train.adam.beta2, epsilon=train.adam.epsilon,
                 weight_decay=train.weight_decay,
                 max_grad_norm=train.gradient_norm)
