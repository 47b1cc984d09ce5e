"""Training precision policy and loss scaling: the float32 policy only.

Counterpart of ffn_tpu/training/precision.py. The port trains in float32
(parameters, convolutions and logits), so `get_policy` knows "f32" and
raises NotImplementedError for "bf16" and "f16" (reduced-precision
training and its DynamicLossScale are still to port, ROADMAP.md). The
loss scale of the f32 policy is `NoOpLossScale`; `all_finite` and
`select_tree` keep the JAX semantics on tensors, on the device (no host
read), and are what K12's plain version does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy (float32 everywhere in the port)."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    @property
    def use_loss_scale(self) -> bool:
        return False


_NOT_PORTED = ("bf16", "f16")


def get_policy(name: str) -> Policy:
    """Parses a policy name; only "f32" is ported."""
    if name == "f32":
        return Policy()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"precision {name!r}: ffn_tpu_torch trains in float32 only; "
            f"bf16/f16 training and DynamicLossScale are still to port "
            f"(ROADMAP.md)")
    raise ValueError(f"unknown precision policy {name!r}; one of "
                     f"{sorted(('f32',) + _NOT_PORTED)}")


class NoOpLossScale:
    """Identity loss scale of the f32 policy; the JAX class's interface."""

    scale = 1.0

    @classmethod
    def init(cls, *a, **k) -> "NoOpLossScale":
        return cls()

    def scale_loss(self, loss):
        return loss

    def unscale(self, tree):
        return tree

    def adjust(self, grads_finite) -> "NoOpLossScale":
        del grads_finite
        return self


def loss_scale_for(policy: Policy) -> NoOpLossScale:
    del policy
    return NoOpLossScale.init()


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
