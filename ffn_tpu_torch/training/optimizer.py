"""The training optimizer: the JAX package's optax chain on the port.

Counterpart of ffn_tpu/training/optimizer.py: the same OptimizerConfig,
the five optimizers, the staircase exponential decay and the +/-0.7
per-entry clip, with optax 0.2.6's arithmetic (adagrad's accumulator 0.1
and eps 1e-7 inside the rsqrt; adam's eps outside the square root;
rmsprop's eps inside the rsqrt, then the rate, then the momentum trace).
A step is one K12 launch (ops/optim.py) over every parameter tensor.

State layout: optax's `chain(clip, core)` state leaves in JAX's order, per
optimizer the groups below, each in JAX's parameter-leaf order
(params_io.jax_leaf_order), a count as one int32 scalar where
`scale_by_schedule` sits: sgd [sched_count]; momentum trace,
[sched_count]; adagrad sum_of_squares, [sched_count]; adam count, mu, nu,
[sched_count]; rmsprop nu, [sched_count], trace. `leaves`/`load_leaves`
map the state to that list (the JAX package's opt.ckpt-N.npz) and back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops import optim as optim_ops


@dataclasses.dataclass
class OptimizerConfig:
    optimizer: str = "sgd"
    learning_rate: float = 0.001
    momentum: float = 0.9
    learning_rate_decay_factor: Optional[float] = None
    decay_steps: Optional[int] = None
    rmsprop_decay: float = 0.9
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    epsilon: float = 1e-8
    # The reference clips each gradient entry to +/- this value.
    max_gradient_entry_mag: float = 0.7


# (groups before the schedule's count, groups after it) in the chain.
_LAYOUT = {
    "sgd": ((), ()),
    "momentum": (("trace",), ()),
    "adagrad": (("sum_of_squares",), ()),
    "adam": (("count", "mu", "nu"), ()),
    "rmsprop": (("nu",), ("trace",)),
}
# The per-parameter groups K12 reads as its state slots s1 and s2.
_SLOTS = {"sgd": (), "momentum": ("trace",), "adagrad": ("sum_of_squares",),
          "adam": ("mu", "nu"), "rmsprop": ("nu", "trace")}
_COUNTS = ("count", "sched_count")
_ADAGRAD_INIT = 0.1   # optax.adagrad's initial_accumulator_value
_ADAGRAD_EPS = 1e-7   # optax.adagrad's eps


def has_schedule(config: OptimizerConfig) -> bool:
    return (config.learning_rate_decay_factor is not None
            and config.decay_steps is not None)


def schedule_from_config(config: OptimizerConfig):
    """The learning rate as a function of the schedule's count (a float32
    tensor), or the constant rate."""
    if not has_schedule(config):
        return config.learning_rate
    h = hyper_from_config(config)
    return lambda count: optim_ops.learning_rate(
        h, torch.as_tensor(count, dtype=torch.int32))


def hyper_from_config(config: OptimizerConfig,
                      ema_decay: float = 0.0) -> optim_ops.Hyper:
    name = config.optimizer
    if name not in _LAYOUT:
        raise ValueError(f"Unknown optimizer: {name}")
    return optim_ops.Hyper(
        opt=name, lr=config.learning_rate,
        clip=max(float(config.max_gradient_entry_mag), 0.0),
        decay_steps=config.decay_steps if has_schedule(config) else None,
        decay_rate=(config.learning_rate_decay_factor
                    if has_schedule(config) else None),
        b1=config.adam_beta1, b2=config.adam_beta2,
        eps=_ADAGRAD_EPS if name == "adagrad" else config.epsilon,
        momentum=config.momentum, rho=config.rmsprop_decay,
        ema_decay=ema_decay)


class Optimizer:
    """`optimizer_from_config`'s chain over a dict of named parameters.

    State: {group: {param name: tensor}} for the per-parameter groups and
    {"count"/"sched_count": 0-d int32 tensor} for the counts, on the
    parameters' device.
    """

    def __init__(self, config: OptimizerConfig, ema_decay: float = 0.0):
        self.config = config
        self.hyper = hyper_from_config(config, ema_decay)
        self.name = config.optimizer
        self._ctrl = {}

    def layout(self) -> List[str]:
        """The state's groups in JAX's leaf order."""
        pre, post = _LAYOUT[self.name]
        return list(pre) + (["sched_count"] if has_schedule(self.config)
                            else []) + list(post)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = {}
        for group in self.layout():
            if group in _COUNTS:
                dev = next(iter(params.values())).device
                state[group] = torch.zeros((), dtype=torch.int32, device=dev)
            else:
                fill = _ADAGRAD_INIT if group == "sum_of_squares" else 0.0
                state[group] = {n: torch.full_like(p.detach(), fill)
                                for n, p in params.items()}
        return state

    def leaves(self, state: dict) -> List[np.ndarray]:
        """The state as JAX lists `jax.tree.leaves(opt_state)`."""
        out = []
        for group in self.layout():
            if group in _COUNTS:
                out.append(state[group].cpu().numpy())
            else:
                tensors = state[group]
                out += [tensors[n].detach().cpu().numpy()
                        for n in params_io.jax_leaf_order(tensors)]
        return out

    def load_leaves(self, state: dict, leaves) -> None:
        """Sets `state` (in place) from JAX-ordered leaves."""
        leaves = list(leaves)
        want = sum(1 if g in _COUNTS else len(state[g])
                   for g in self.layout())
        if len(leaves) != want:
            raise ValueError(f"{self.name} state has {want} leaves, got "
                             f"{len(leaves)}")
        it = iter(leaves)
        for group in self.layout():
            if group in _COUNTS:
                state[group].copy_(torch.as_tensor(
                    np.asarray(next(it), np.int32).reshape(())))
                continue
            tensors = state[group]
            for n in params_io.jax_leaf_order(tensors):
                t = tensors[n]
                t.copy_(torch.as_tensor(np.asarray(
                    next(it), np.float32).reshape(tuple(t.shape))))

    def update(self, params: Dict[str, torch.Tensor],
               grads: List[torch.Tensor], state: dict,
               ema: Optional[Dict[str, torch.Tensor]],
               active: torch.Tensor, finite_out: torch.Tensor,
               gated: bool = True, loss_scale=None) -> None:
        """One step in place (K12): `grads` in `params`' order; `active`
        and `finite_out` are 0-d device tensors (the offset's valid lanes
        and its grads_finite metric); gated on `(active > 0) & finite`
        unless `gated` is False; `loss_scale`: a DynamicLossScale to
        unscale with and adjust in place, or None."""
        names = list(params)
        slots = [[state[g][n] for n in names] for g in _SLOTS[self.name]]
        slots += [[None] * len(names)] * (2 - len(slots))
        dev = params[names[0]].device
        ctrl = None
        if dev.type == "cuda":
            if dev not in self._ctrl:
                self._ctrl[dev] = optim_ops.ctrl_buffer(dev)
            ctrl = self._ctrl[dev]
        with torch.no_grad():
            optim_ops.optim_update(
                [params[n] for n in names], [g.contiguous() for g in grads],
                slots[0], slots[1],
                [ema[n] for n in names] if ema is not None else None,
                self.hyper, state.get("count"), state.get("sched_count"),
                active, finite_out, ctrl, gated=gated, loss_scale=loss_scale)


def optimizer_from_config(config: OptimizerConfig,
                          ema_decay: float = 0.0) -> Optimizer:
    return Optimizer(config, ema_decay)
