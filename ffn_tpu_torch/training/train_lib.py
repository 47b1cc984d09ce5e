"""FFN training on one card: the scan and host-loop train steps.

Counterpart of ffn_tpu/training/train_lib.py's scan trainer (the explicit
and packed steps and their shared body, :158-422) and host-loop step
(`make_fov_train_step`, :425-505). A scan step loops over the fixed
offsets in Python; per offset, in the JAX body's order: K11 train_gather
(gate and crops) -> the ConvStack3D forward under autograd (K1, or K15 in
16 bits) -> K11 train_loss (loss, dloss/dlogits times the loss scale, the
seed write-back, counts) -> the backward (K9/K10, or K17/K18) -> K12
(unscale, finite gate, clipped update, EMA, the loss scale's adjust); then
K11 train_eval (packed). Nothing is read on the host inside the loop; the
forward at offset k uses offset k - 1's parameters, updated in place. The
host-loop step is one pass over one FOV batch: the forward, K16 fov_loss,
the backward, K12 (ungated in the legacy form, gated with the EMA with a
config).

The precision policy (`config.precision`, precision.py) sets the loss
scale (f16: DynamicLossScale, device tensors); the model's dtype sets the
convolutions' (train_loop sets it from the policy). The scan steps refuse
max_pred_moves and no_step as the JAX package does; remat and meshes raise
NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from scipy.special import logit as np_logit

from ffn_tpu_torch.models import model_info as model_info_lib
from ffn_tpu_torch.ops import train as train_ops
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import precision as precision_lib

NOT_PORTED = "is not ported to ffn_tpu_torch yet (ROADMAP.md)"


@dataclasses.dataclass
class TrainConfig:
    fov_size: Sequence[int] = (33, 33, 33)          # xyz
    deltas: Sequence[int] = (8, 8, 8)               # xyz
    depth: int = 12
    features: int = 32
    batch_size: int = 8
    fov_moves: int = 1
    fov_policy: str = "fixed"   # fixed | fixed_window (both trainers);
    #                             max_pred_moves | no_step (host loop)
    fixed_window_radius: int = 8
    threshold: float = 0.9      # move gate (probability space)
    seed_pad: float = 0.05
    seed_init: float = 0.95
    image_mean: float = 128.0
    image_stddev: float = 33.0
    shuffle_fov_moves: bool = False
    ema_decay: float = 0.0      # 0 disables EMA params
    precision: str = "f32"      # f32 | bf16 | f16 (precision.py)
    packed_transfers: bool = True
    label_softness: float = 0.05
    remat: bool = False         # not ported
    optimizer: optimizer_lib.OptimizerConfig = dataclasses.field(
        default_factory=optimizer_lib.OptimizerConfig)


def fov_moves(config: TrainConfig) -> int:
    # One extra move for better fill of the eval area (train.py:155-159).
    if config.fov_policy == "max_pred_moves":
        return config.fov_moves + 1
    return config.fov_moves


def train_canvas_size(info, config: TrainConfig) -> np.ndarray:
    return (np.array(info.input_seed_size)
            + np.array(info.deltas) * 2 * fov_moves(config))


def train_image_size(info, config: TrainConfig) -> np.ndarray:
    return (np.array(info.input_image_size)
            + np.array(info.deltas) * 2 * fov_moves(config))


def train_labels_size(info, config: TrainConfig) -> np.ndarray:
    return (np.array(info.pred_mask_size)
            + np.array(info.deltas) * 2 * fov_moves(config))


def train_eval_size(info, config: TrainConfig) -> np.ndarray:
    return (np.array(info.pred_mask_size)
            + np.array(info.deltas) * 2 * config.fov_moves)


def fixed_offsets_zyx(info, shuffle: bool = False,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """(S, 3) int32 offsets: center first, then the 26 delta shifts (zyx)."""
    shifts = model_info_lib.shift_collection(info.deltas)  # xyz
    shifts = [s[::-1] for s in shifts]
    if shuffle:
        rng = rng or np.random.RandomState(0)
        order = rng.permutation(len(shifts))
        shifts = [shifts[i] for i in order]
    return np.array([(0, 0, 0)] + shifts, np.int32)


sigmoid_ce = train_ops.sigmoid_ce


def _fov_zyx(info) -> tuple:
    """The model's FOV (zyx); its image, seed and prediction sizes must
    agree."""
    fov_zyx = tuple(int(v) for v in info.input_seed_size[::-1])
    pred_zyx = tuple(int(v) for v in info.pred_mask_size[::-1])
    img_zyx = tuple(int(v) for v in info.input_image_size[::-1])
    if not fov_zyx == pred_zyx == img_zyx:
        raise NotImplementedError(
            f"models whose image, seed and prediction sizes differ "
            f"{NOT_PORTED}")
    return fov_zyx


def check_config(config: TrainConfig):
    """Raises NotImplementedError for what the port does not train yet."""
    precision_lib.get_policy(config.precision)
    if config.remat:
        raise NotImplementedError(f"remat {NOT_PORTED}")


def check_scan_config(config: TrainConfig):
    """check_config, and the scan trainer's policies, refused with the JAX
    package's error (ffn_tpu/training/train_loop.py:248-252)."""
    if config.fov_policy not in ("fixed", "fixed_window"):
        raise NotImplementedError(
            f"the scan trainer drives static-offset policies (fixed, "
            f"fixed_window); got {config.fov_policy!r}. Use "
            f"run_training_host_loop for max_pred_moves/no_step.")
    check_config(config)


@dataclasses.dataclass
class ScanTrainState:
    """params: the model's parameters by name (the module's own tensors,
    updated in place); opt_state: Optimizer.init's state; ema_params: a
    copy of the parameters (or None)."""
    params: Any
    opt_state: Any
    ema_params: Any
    step: int
    scale_state: Any = None


def create_train_state(model, config: TrainConfig
                       ) -> tuple[ScanTrainState, optimizer_lib.Optimizer]:
    """The state of training `model` from its current parameters (the JAX
    package draws them in create_train_state; here the caller initialises
    or loads the model first)."""
    check_config(config)
    params = dict(model.module.named_parameters())
    opt = optimizer_lib.optimizer_from_config(config.optimizer,
                                              config.ema_decay)
    ema = ({n: p.detach().clone() for n, p in params.items()}
           if config.ema_decay > 0 else None)
    policy = precision_lib.get_policy(config.precision)
    dev = next(iter(params.values())).device
    return ScanTrainState(params=params, opt_state=opt.init(params),
                          ema_params=ema, step=0,
                          scale_state=precision_lib.loss_scale_for(
                              policy, device=dev)), opt


def _dynamic(scale_state):
    """(the scale tensor, the DynamicLossScale) or (None, None) for a
    NoOpLossScale."""
    if isinstance(scale_state, precision_lib.DynamicLossScale):
        return scale_state.scale, scale_state
    return None, None


class _Body:
    """The per-offset work shared by both step variants."""

    def __init__(self, model, opt, config: TrainConfig):
        check_scan_config(config)
        self.model = model
        self.opt = opt
        self.fov_zyx = _fov_zyx(model.info)
        self.move_t = float(np_logit(config.threshold))
        self.label_t = float(config.threshold)
        self.window = ((int(config.fixed_window_radius),
                        tuple(int(v) for v in model.info.deltas[::-1]))
                       if config.fov_policy == "fixed_window" else None)
        self.ticket = None

    def run(self, state: ScanTrainState, seeds, images, labels, weights,
            offsets):
        """Every offset of one batch; returns the per-offset metrics."""
        offsets = np.asarray(offsets)
        dev = seeds.device
        if self.ticket is None or self.ticket.device != dev:
            self.ticket = train_ops.new_ticket(dev)
        s = len(offsets)
        table = torch.empty((s, len(train_ops.METRICS)), dtype=torch.float32,
                            device=dev)
        finite = torch.empty((s,), dtype=torch.bool, device=dev)
        scales = torch.ones((s,), dtype=torch.float32, device=dev)
        scale, dynamic = _dynamic(state.scale_state)
        names = list(state.params)
        params = [state.params[n] for n in names]
        for i, off in enumerate(offsets):
            off = tuple(int(v) for v in off)
            x_in, seed_patch, valid, wanted = train_ops.train_gather(
                seeds, images, labels, off, self.fov_zyx, self.move_t,
                self.label_t, self.window)
            logits = self.model.train_apply(x_in, seed_patch)
            dlogits = train_ops.train_loss(
                logits.detach(), seeds, labels, weights, valid, wanted, off,
                table[i], self.ticket, scale=scale)
            grads = torch.autograd.grad(logits, params, dlogits)
            del logits, x_in
            self.opt.update(state.params, list(grads), state.opt_state,
                            state.ema_params, table[i, 1], finite[i],
                            loss_scale=dynamic)
            if dynamic is not None:
                scales[i].copy_(dynamic.scale)
        metrics = {k: table[:, j] for j, k in enumerate(train_ops.METRICS)}
        for k in ("correct", "missed", "spurious"):
            metrics[k] = metrics[k].to(torch.int32)
        metrics["grads_finite"] = finite
        metrics["loss_scale"] = scales
        return metrics


def make_scan_train_step(model, opt, config: TrainConfig, mesh=None):
    """The explicit-canvas step (packed_transfers=False):

      (state, seeds, images, labels, weights, offsets) -> (state, seeds,
                                                           metrics)

    seeds/images: (B, cz, cy, cx, 1) float32 canvases; labels/weights:
    (B, lz, ly, lx, 1); offsets: (S, 3) int zyx on the host, centre first.
    The returned seeds are the input canvas, written in place."""
    if mesh is not None:
        raise NotImplementedError(f"mesh= {NOT_PORTED}: the port trains on "
                                  f"one card")
    body = _Body(model, opt, config)

    def train_step(state, seeds, images, labels, weights, offsets):
        metrics = body.run(state, seeds, images, labels, weights, offsets)
        state.step += 1
        return state, seeds, metrics

    return train_step


def make_scan_train_step_packed(model, opt, config: TrainConfig, mesh=None):
    """The minimum-transfer step:

      (state, image_u8, lom_u8, offsets) -> (state, metrics)

    image_u8: (B, cz, cy, cx, 1) uint8; lom_u8: (B, lz, ly, lx, 1) uint8
    {0, 1}. Normalization, soft labels and the seed canvases are built on
    the device (K11 train_prep); after the offsets the eval-region metrics
    are too (K11 train_eval), so only scalars need to reach the host."""
    if mesh is not None:
        raise NotImplementedError(f"mesh= {NOT_PORTED}: the port trains on "
                                  f"one card")
    body = _Body(model, opt, config)
    info = model.info
    canvas_zyx = tuple(int(v) for v in train_canvas_size(info, config)[::-1])
    eval_zyx = tuple(int(v) for v in train_eval_size(info, config)[::-1])
    pad_logit = float(np_logit(config.seed_pad))
    init_logit = float(np_logit(config.seed_init))

    def train_step(state, image_u8, lom_u8, offsets):
        images, labels, seeds = train_ops.train_prep(
            image_u8, lom_u8, canvas_zyx, config.image_mean,
            config.image_stddev, config.label_softness, pad_logit, init_logit)
        metrics = body.run(state, seeds, images, labels, None, offsets)
        patch_loss, counts = train_ops.train_eval(seeds, labels, eval_zyx,
                                                  body.ticket)
        metrics["patch_loss"] = patch_loss
        for j, k in enumerate(("tp", "fp", "fn", "tn")):
            metrics[k] = counts[j]
        state.step += 1
        return state, metrics

    return train_step


def make_fov_train_step(model, opt, mesh=None, config=None):
    """The host-loop trainer's single-FOV step (one forward and backward pass,
    the seed stop-gradient-ed). Without config (legacy) the update applies
    whatever the gradients hold (a NaN reaches the parameters, as in JAX):
      (params, opt_state, seed, image, labels, weights) ->
          (params, opt_state, logits, loss)
    With config it is skipped unless every gradient is finite, the EMA
    (ema_decay > 0) updates every step, and f16's loss scale applies:
      (params, opt_state, ema_params, scale_state, seed, image, labels,
       weights) -> (params, opt_state, ema_params, scale_state, logits, loss)
    The state is create_train_state's (the model's own parameters), updated
    in place; inputs (B, z, y, x, 1) float32 on the model's device; logits
    and the 0-d loss stay there."""
    if mesh is not None:
        raise NotImplementedError(f"mesh= {NOT_PORTED}: the port trains on "
                                  f"one card")
    if config is not None:
        check_config(config)
    _fov_zyx(model.info)
    own = dict(model.module.named_parameters())
    names = list(own)
    scratch = {}

    def run(params, opt_state, ema_params, scale_state, seed, image, labels,
            weights, gated):
        if len(params) != len(own) or any(params.get(n) is not own[n]
                                          for n in names):
            raise ValueError("make_fov_train_step: params must be the "
                             "model's own tensors (create_train_state's)")
        dev = seed.device
        if scratch.get("device") != dev:
            scratch.update(device=dev, ticket=train_ops.new_ticket(dev),
                           active=torch.ones((), device=dev),
                           finite=torch.empty((), dtype=torch.bool,
                                              device=dev))
        net = torch.cat([image, seed], dim=-1)
        logits = model.train_apply(net, seed.detach())
        scale, dynamic = _dynamic(scale_state)
        dlogits, loss = train_ops.fov_loss(logits.detach(), labels, weights,
                                           scratch["ticket"], scale=scale)
        grads = torch.autograd.grad(logits, [params[n] for n in names],
                                    dlogits)
        opt.update(params, list(grads), opt_state, ema_params,
                   scratch["active"], scratch["finite"], gated=gated,
                   loss_scale=dynamic)
        return logits.detach(), loss

    if config is None:
        def train_step(params, opt_state, seed, image, labels, weights):
            logits, loss = run(params, opt_state, None, None, seed, image,
                               labels, weights, gated=False)
            return params, opt_state, logits, loss
    else:
        def train_step(params, opt_state, ema_params, scale_state, seed,
                       image, labels, weights):
            logits, loss = run(params, opt_state, ema_params, scale_state,
                               seed, image, labels, weights, gated=True)
            return (params, opt_state, ema_params, scale_state, logits,
                    loss)
    return train_step


def make_seed_canvas(batch: int, canvas_zyx, pad: float, init: float
                     ) -> np.ndarray:
    """Batch of logit-space seed canvases with active center voxels."""
    from ffn_tpu_torch.training import mask as mask_lib
    return np_logit(mask_lib.make_seed(canvas_zyx, batch, pad=pad,
                                       seed=init)).astype(np.float32)
