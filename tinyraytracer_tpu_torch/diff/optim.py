"""Gradient transformations in optax's form: what the training step of
diff/inverse.py uses from optax, in PyTorch.

A transformation is a pair (init(params) -> state, update(updates, state,
params) -> (updates, state)) over dicts of tensors. `adam` reproduces
optax.adam's update order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g*g +
b2 nu, both bias-corrected by the step count, update = mu_hat /
(sqrt(nu_hat) + eps) scaled by -learning_rate. torch.optim.Adam rounds in
another order, so it is not used. All state stays on the parameters'
device; nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # () int32
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    pass


def _like(params: dict, fn) -> dict:
    return {k: fn(v) for k, v in params.items()}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no Nesterov)."""

    def init(params):
        dev = next(iter(params.values())).device
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=_like(params, torch.zeros_like),
            nu=_like(params, torch.zeros_like))

    def update(updates, state, params=None):
        del params
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k]
              for k, g in updates.items()}
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(c, b1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, b2), c)
        out = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
               for k in updates}
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    """optax.scale: multiply every update by `step_size`."""

    def init(params):
        del params
        return EmptyState()

    def update(updates, state, params=None):
        del params
        return {k: g * step_size for k, g in updates.items()}, state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax.chain: apply `transforms` in order; the state is a tuple."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam with a constant learning rate."""
    return chain(scale_by_adam(b1, b2, eps), scale(-learning_rate))


def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates: params + updates, in the params' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
