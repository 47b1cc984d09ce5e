"""K12 optim_update: the clipped optimizer step, finite gate, EMA and the
loss scale, in one launch over a table of the model's parameter tensors
(`csrc/optim.cu`), in place: with a DynamicLossScale (f16) the gradients
unscaled, g * (1 / scale); the finite test; gated on `(active > 0) &
finite` the clip and the optax 0.2.6 step (sgd, momentum, adagrad, adam,
rmsprop, staircase decay); the EMA whenever ema_decay > 0
(train_lib.py:368-388, optimizer.py:45-69); the scale's adjust(finite).
Without the update everything keeps its value (`where`/`select_tree`);
`gated=False` updates whatever the gradients hold (the legacy host-loop
step, train_lib.py:445-458). Nothing is read on the host.
`optim_update_plain`, the same in torch ops, runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.training import precision

NAME = "optim_update"
OPTIMIZERS = ("sgd", "momentum", "adagrad", "adam", "rmsprop")
MAX_TENSORS = 64   # csrc/optim.cu kMaxTensors


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The step's constants. `decay_steps`/`decay_rate` set the staircase
    schedule (None: a constant learning rate)."""
    opt: str
    lr: float
    clip: float = 0.7
    decay_steps: Optional[int] = None
    decay_rate: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9
    rho: float = 0.9
    ema_decay: float = 0.0

    @property
    def decays(self) -> bool:
        return (self.decay_steps is not None and self.decay_rate is not None
                and self.decay_steps > 0 and self.decay_rate != 0)


def _f32(v) -> float:
    return float(np.float32(v))


def learning_rate(h: Hyper, count: Optional[torch.Tensor]) -> torch.Tensor:
    """optax.exponential_decay(staircase=True) at `count`, float32, on the
    count's device; the constant rate without a decaying schedule."""
    if count is None or not h.decays:
        return torch.tensor(_f32(h.lr))
    p = torch.floor(count.to(torch.float32) / np.float32(h.decay_steps))
    decayed = np.float32(h.lr) * torch.pow(
        torch.tensor(_f32(h.decay_rate), device=count.device), p)
    return torch.where(count <= 0, torch.tensor(_f32(h.lr),
                                                device=count.device), decayed)


def _safe_increment(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c < np.iinfo(np.int32).max, c + 1, c)


def optim_update_plain(params, grads, s1, s2, ema, h: Hyper, adam_count,
                       sched_count, active, finite_out, *, gated=True,
                       loss_scale=None):
    dev = params[0].device
    if loss_scale is not None:
        grads = loss_scale.unscale(grads)
    finite = precision.all_finite(grads)
    do_update = finite & (active > 0) if gated else torch.ones(
        (), dtype=torch.bool, device=dev)
    step = -learning_rate(h, sched_count).to(dev)
    if h.opt == "adam":
        c1 = _safe_increment(adam_count).to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(_f32(h.b1), device=dev), c1)
        bc2 = 1.0 - torch.pow(torch.tensor(_f32(h.b2), device=dev), c1)
    for j, (p, g) in enumerate(zip(params, grads)):
        if h.clip > 0:
            g = torch.clamp(g, -h.clip, h.clip)
        new1, new2 = s1[j], s2[j]
        if h.opt == "momentum":
            new1 = g + _f32(h.momentum) * s1[j]
            u = step * new1
        elif h.opt == "adagrad":
            new1 = g * g + s1[j]
            inv = torch.where(new1 > 0, 1.0 / torch.sqrt(new1 + _f32(h.eps)),
                              torch.zeros((), device=dev))
            u = step * (inv * g)
        elif h.opt == "adam":
            new1 = _f32(1 - h.b1) * g + _f32(h.b1) * s1[j]
            new2 = _f32(1 - h.b2) * (g * g) + _f32(h.b2) * s2[j]
            u = step * ((new1 / bc1) / (torch.sqrt(new2 / bc2) + _f32(h.eps)))
        elif h.opt == "rmsprop":
            new1 = _f32(1 - h.rho) * (g * g) + _f32(h.rho) * s1[j]
            scaled = step * ((1.0 / torch.sqrt(new1 + _f32(h.eps))) * g)
            new2 = scaled + _f32(h.momentum) * s2[j]
            u = new2
        else:
            u = step * g
        # Without the update everything keeps its value (select_tree).
        for dst, src in zip((p, s1[j], s2[j]), precision.select_tree(
                do_update, (p + u, new1, new2), (p, s1[j], s2[j]))):
            if dst is not None:
                dst.copy_(src)
        if ema is not None:
            ema[j].copy_(_f32(h.ema_decay) * ema[j]
                         + _f32(1.0 - h.ema_decay) * p)
    for count in (adam_count, sched_count):
        if count is not None:
            count.copy_(torch.where(do_update, _safe_increment(count), count))
    finite_out.copy_(finite)
    if loss_scale is not None:
        new = loss_scale.adjust(finite)
        loss_scale.scale.copy_(new.scale)
        loss_scale.counter.copy_(new.counter)


def ctrl_buffer(device) -> torch.Tensor:
    """The kernel's barrier and flag scratch for `device` (zeroed once)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.zeros(2 + sms, dtype=torch.int32, device=device)


def optim_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 s1: List[Optional[torch.Tensor]],
                 s2: List[Optional[torch.Tensor]],
                 ema: Optional[List[torch.Tensor]], h: Hyper,
                 adam_count: Optional[torch.Tensor],
                 sched_count: Optional[torch.Tensor], active: torch.Tensor,
                 finite_out: torch.Tensor,
                 ctrl: Optional[torch.Tensor] = None, *, gated: bool = True,
                 loss_scale: Optional[precision.DynamicLossScale] = None):
    """K12, in place. `s1`/`s2`: the optimizer's per-parameter state
    (momentum/adagrad: s1; adam: mu, nu; rmsprop: nu, trace); `active` a
    0-d float32 tensor (the offset's valid lanes), `finite_out` a 0-d bool
    tensor for the grads_finite metric; `ctrl` from ctrl_buffer (CUDA);
    `gated=False` drops the `(active > 0) & finite` gate; `loss_scale` a
    DynamicLossScale on the parameters' device (its tensors adjusted in
    place), or None."""
    if h.opt not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: {h.opt}")
    n = len(params)
    if not (len(grads) == len(s1) == len(s2) == n) or (
            ema is not None and len(ema) != n):
        raise ValueError(f"{NAME}: lists of different lengths")
    needs = {"momentum": (1, 0), "adagrad": (1, 0), "adam": (1, 1),
             "rmsprop": (1, 1)}.get(h.opt, (0, 0))
    tensors = list(params) + list(grads)
    for slot, need in zip((s1, s2), needs):
        if need:
            tensors += list(slot)
    tensors += list(ema or [])
    for j, (p, g) in enumerate(zip(params, grads)):
        group = [p, g] + [slot[j] for slot, need in zip((s1, s2), needs)
                          if need] + ([ema[j]] if ema is not None else [])
        for t in group:
            if t.shape != p.shape or t.dtype != torch.float32:
                raise ValueError(f"{NAME}: tensor {j}: want float32 "
                                 f"{tuple(p.shape)}, got {tuple(t.shape)} "
                                 f"{t.dtype}")
    if h.opt == "adam" and adam_count is None:
        raise ValueError(f"{NAME}: adam needs its count")
    dev = params[0].device
    scale_ts = ([loss_scale.scale, loss_scale.counter]
                if loss_scale is not None else [])
    if scale_ts and (scale_ts[0].dtype != torch.float32
                     or scale_ts[1].dtype != torch.int32):
        raise ValueError(f"{NAME}: the loss scale must be float32, its "
                         f"counter int32")
    for t in tensors + [active, finite_out] + scale_ts:
        if t.device != dev:
            raise ValueError(f"{NAME}: tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return optim_update_plain(params, grads, s1, s2, ema, h, adam_count,
                                  sched_count, active, finite_out,
                                  gated=gated, loss_scale=loss_scale)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {dev}")
    if n > MAX_TENSORS:
        raise ValueError(f"{NAME}: at most {MAX_TENSORS} tensors, got {n}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{NAME} takes contiguous tensors")
    if ctrl is None or ctrl.device != dev or ctrl.dtype != torch.int32:
        raise ValueError(f"{NAME}: needs its ctrl_buffer on {dev}")

    def ptrs(ts):
        return [t.data_ptr() if t is not None else None for t in ts]

    keep = [_build.host_array(ctypes.c_void_p, ptrs(params)),
            _build.host_array(ctypes.c_void_p, ptrs(grads)),
            _build.host_array(ctypes.c_void_p,
                              ptrs(s1) if needs[0] else [None] * n),
            _build.host_array(ctypes.c_void_p,
                              ptrs(s2) if needs[1] else [None] * n),
            _build.host_array(ctypes.c_void_p,
                              ptrs(ema) if ema is not None else [None] * n),
            _build.host_array(ctypes.c_longlong, [p.numel() for p in params]),
            _build.host_array(ctypes.c_int, [
                OPTIMIZERS.index(h.opt), int(h.decays),
                int(h.decay_steps or 1), int(ema is not None), int(gated)]),
            _build.host_array(ctypes.c_float, [
                _f32(h.clip), _f32(h.lr), _f32(h.decay_rate or 1.0),
                _f32(h.b1), _f32(1 - h.b1), _f32(h.b2), _f32(1 - h.b2),
                _f32(h.eps), _f32(h.momentum), _f32(h.rho), _f32(1 - h.rho),
                _f32(h.ema_decay), _f32(1.0 - h.ema_decay)])]
    addrs = [addr for _, addr in keep]
    err = _build.lib().ffn_optim_update(
        *addrs[:6], n, *addrs[6:],
        adam_count.data_ptr() if adam_count is not None else None,
        sched_count.data_ptr() if sched_count is not None else None,
        active.data_ptr(), finite_out.data_ptr(), ctrl.data_ptr(),
        ctrl.numel(), *([t.data_ptr() for t in scale_ts] or [None, None]),
        loss_scale.growth_interval if loss_scale is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    del keep
    _build.check(err, NAME)
    # Launches with a loss scale count as optim_update_scaled.
    _build.launches[NAME + ("_scaled" if scale_ts else "")] += 1
