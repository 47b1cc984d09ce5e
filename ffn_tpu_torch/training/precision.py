"""Training precision policies and dynamic loss scaling.

Counterpart of ffn_tpu/training/precision.py: policies "f32", "bf16" and
"f16" (float32 parameters, convolutions in the compute dtype), the f16
policy's `DynamicLossScale` and the others' `NoOpLossScale`, with the JAX
semantics. The port's DynamicLossScale holds device tensors (float32
`scale`, int32 `counter`), which K12 (ops/optim.py) unscales with and
adjusts in place with no host read; `adjust` returns the adjusted state as
JAX's does. The scale starts at a power of two and only doubles or halves
(>= 1), so scaling and unscaling in float32 are exact. `all_finite` and
`select_tree` are K12's plain version's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy: float32 parameters, convolutions in compute_dtype,
    float32 logits."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    @property
    def use_loss_scale(self) -> bool:
        # bf16 shares f32's exponent range; scaling only matters for fp16.
        return self.compute_dtype == torch.float16


_POLICIES = {
    "f32": Policy(),
    "bf16": Policy(compute_dtype=torch.bfloat16),
    "f16": Policy(compute_dtype=torch.float16),
}


def get_policy(name: str) -> Policy:
    """Parses a policy name ("f32" | "bf16" | "f16")."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; one of "
                         f"{sorted(_POLICIES)}") from None


class DynamicLossScale:
    """Grows the scale 2x after `growth_interval` consecutive finite steps;
    halves it (>= 1) on any non-finite gradient. `scale` (float32) and
    `counter` (int32) are 0-d tensors on the training device."""

    def __init__(self, scale: torch.Tensor, counter: torch.Tensor,
                 growth_interval: int = 2000):
        self.scale = scale
        self.counter = counter
        self.growth_interval = growth_interval

    @classmethod
    def init(cls, initial_scale: float = 2.0 ** 15,
             growth_interval: int = 2000, device=None) -> "DynamicLossScale":
        return cls(torch.tensor(initial_scale, dtype=torch.float32,
                                device=device),
                   torch.zeros((), dtype=torch.int32, device=device),
                   growth_interval)

    def leaves(self) -> list:
        """The state as the JAX pytree's leaves: [scale, counter]."""
        return [self.scale, self.counter]

    def scale_loss(self, loss):
        return loss * self.scale.to(loss.dtype)

    def unscale(self, tensors) -> list:
        inv = 1.0 / self.scale
        return [g * inv.to(g.dtype) for g in tensors]

    def adjust(self, grads_finite) -> "DynamicLossScale":
        grow = self.counter + 1 >= self.growth_interval
        new_scale = torch.where(
            grads_finite, torch.where(grow, self.scale * 2.0, self.scale),
            torch.clamp(self.scale * 0.5, min=1.0))
        new_counter = torch.where(grads_finite & ~grow, self.counter + 1,
                                  torch.zeros_like(self.counter))
        return DynamicLossScale(new_scale, new_counter, self.growth_interval)


class NoOpLossScale:
    """Identity loss scale of the f32 and bf16 policies; the same
    interface, no state."""

    scale = 1.0

    @classmethod
    def init(cls, *a, **k) -> "NoOpLossScale":
        return cls()

    def leaves(self) -> list:
        return []

    def scale_loss(self, loss):
        return loss

    def unscale(self, tensors):
        return tensors

    def adjust(self, grads_finite) -> "NoOpLossScale":
        del grads_finite
        return self


def loss_scale_for(policy: Policy, device=None):
    return (DynamicLossScale.init(device=device) if policy.use_loss_scale
            else NoOpLossScale.init())


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every element of every tensor is finite."""
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def select_tree(pred: torch.Tensor, on_true, on_false) -> list:
    """Branch-free per-tensor select: where(pred, on_true, on_false); a
    None (a state slot an optimizer does not have) stays None."""
    return [torch.where(pred, t, f) if t is not None else None
            for t, f in zip(on_true, on_false)]
