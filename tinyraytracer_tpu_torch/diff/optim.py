"""Gradient transformations in optax's form: what the training step of
diff/inverse.py uses from optax, in PyTorch.

A transformation is a pair (init(params) -> state, update(updates, state,
params) -> (updates, state)) over dicts of tensors. `adam` reproduces
optax.adam's update order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g*g +
b2 nu, both bias-corrected by the step count, update = mu_hat /
(sqrt(nu_hat) + eps) scaled by -learning_rate. torch.optim.Adam rounds in
another order, so it is not used. All state stays on the parameters'
device; nothing here reads a value back to the host.

A schedule maps a step count (a 0-dim int32 tensor) to a value, as an
optax schedule does; `constant_schedule`, `exponential_decay` and
`join_schedules` compute theirs in float32 on the count's device.
`adam` takes a schedule as its rate, and `multi_transform` runs one
transformation per group of fields (optax 0.2.6's semantics).
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Sequence, Union

import torch

Schedule = Callable[[torch.Tensor], Union[float, torch.Tensor]]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # () int32
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    pass


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor   # () int32


class MultiTransformState(NamedTuple):
    inner_states: dict    # group label -> that group's state


_INT32_MAX = 2**31 - 1


def _like(params: dict, fn) -> dict:
    return {k: fn(v) for k, v in params.items()}


def _device(params: dict) -> torch.device:
    """The parameters' device (the CPU for an empty group)."""
    return next(iter(params.values())).device if params else \
        torch.device("cpu")


def _count(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax.safe_increment: count + 1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """`x` (a number or a tensor) as float32 on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def constant_schedule(value: float) -> Schedule:
    """optax.constant_schedule."""
    return lambda count: value


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: float | None = None) -> Schedule:
    """optax.exponential_decay: init_value * decay_rate ** p with p =
    (count - transition_begin) / transition_steps (floored with
    `staircase`), and init_value wherever count <= transition_begin;
    clamped at `end_value` when given. All in float32, as optax computes
    it: the quotient divides by a tensor, never by a host scalar (CUDA
    multiplies by a host scalar's reciprocal instead)."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        dc = torch.as_tensor(count) - transition_begin
        p = dc.to(torch.float32) / _f32(float(transition_steps), dc)
        if staircase:
            p = torch.floor(p)
        init = _f32(init_value, p)
        value = torch.where(dc <= 0, init,
                            init * torch.pow(_f32(decay_rate, p), p))
        if end_value is not None:
            clip = torch.maximum if decay_rate < 1.0 else torch.minimum
            value = clip(value, _f32(end_value, p))
        return value

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedules[i + 1] takes over at boundaries[i]
    and is called with the count since that boundary."""

    def schedule(count):
        count = torch.as_tensor(count)
        out = _f32(schedules[0](count), count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out,
                              _f32(sched(count - boundary), count))
        return out

    return schedule


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no Nesterov)."""

    def init(params):
        return ScaleByAdamState(
            count=_count(params),
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


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """optax.scale_by_schedule: multiply every update by
    step_size_fn(count), where count is the number of updates before this
    one (so the first update takes step_size_fn(0))."""

    def init(params):
        return ScaleByScheduleState(count=_count(params))

    def update(updates, state, params=None):
        del params
        step = step_size_fn(state.count)
        out = {k: torch.as_tensor(step, dtype=g.dtype, device=g.device) * g
               for k, g in updates.items()}
        return out, ScaleByScheduleState(count=_increment(state.count))

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


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: scale_by_adam, then the negated rate, a constant
    (`scale`) or a schedule of the step count (`scale_by_schedule`)."""
    if callable(learning_rate):
        return chain(scale_by_adam(b1, b2, eps),
                     scale_by_schedule(lambda c: -learning_rate(c)))
    return chain(scale_by_adam(b1, b2, eps), scale(-learning_rate))


def multi_transform(transforms: Mapping[str, GradientTransformation],
                    param_labels) -> GradientTransformation:
    """optax.multi_transform: each field gets the transformation of its
    label. `param_labels` is a dict from field to label, or a callable
    that returns one for the dict it is given. Each transformation sees
    only the dict of its own fields, which is what optax's masking amounts
    to for transformations that treat fields one by one (Adam, the
    inverse example's per-field adaptive_clip). A field with no label, or
    a label with no transformation, raises ValueError."""

    def groups(tree: dict) -> dict:
        labels = param_labels(tree) if callable(param_labels) else \
            param_labels
        unlabelled = [k for k in tree if k not in labels]
        if unlabelled:
            raise ValueError(f"fields {unlabelled} have no label")
        unknown = sorted({labels[k] for k in tree} - set(transforms))
        if unknown:
            raise ValueError(f"labels {unknown} have no transformation; "
                             f"transformations: {sorted(transforms)}")
        return {g: [k for k in tree if labels[k] == g] for g in transforms}

    def init(params):
        return MultiTransformState({
            g: transforms[g].init({k: params[k] for k in keys})
            for g, keys in groups(params).items()})

    def update(updates, state, params=None):
        out, inner = dict(updates), {}
        for g, keys in groups(updates).items():
            sub = None if params is None else {k: params[k] for k in keys}
            u, inner[g] = transforms[g].update(
                {k: updates[k] for k in keys}, state.inner_states[g], sub)
            out.update(u)
        return out, MultiTransformState(inner)

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates: params + updates, in the params' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
