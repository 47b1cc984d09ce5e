"""K11 train_step_ops and K16 fov_loss: the train steps' passes around
the conv stack, each beside its plain PyTorch version.

K11 (the scan step, ffn_tpu/training/train_lib.py): `train_prep`, the
packed prelude (:239-248: normalized image, soft labels, the seed canvas);
`train_gather`, one offset's gate and crops (:341-355, fixed_window
:326-335) with the model input's concatenation fused; `train_loss`, the
masked sigmoid CE, dloss/dlogits (times the loss scale), the seed
write-back and the counts (:357-366, :390-411); `train_eval`, the eval
region's CE and tp/fp/fn/tn (:255-266). K16 `fov_loss` (make_fov_train_step,
:425-505): mean(sigmoid_ce(x, z) w) over the batch, ungated, and w
(sigmoid(x) - z) / N, with a deterministic reduction; at x = 0 exactly
-w z / N, as jax.grad (max splits its tie, abs' derivative at 0 is 1).

Canvases are (B, z, y, x) float32 (JAX's without the channel). Crop starts
are computed on the host with `clamp_start` (wrap once, then clamp); no
wrapper reads a device value on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops.step import clamp_start

PREP, GATHER, LOSS, EVAL = ("train_prep", "train_gather", "train_loss",
                            "train_eval")
FOV_LOSS = "fov_loss"
LOSS_CHUNK = 2048   # voxels of one lane per train_loss block
EVAL_CHUNK = 4096   # voxels per train_eval block
FOV_CHUNK = 4096    # voxels per fov_loss block
METRICS = ("loss", "active", "correct", "missed", "spurious")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def new_ticket(device) -> torch.Tensor:
    """The last-block ticket of train_loss, train_eval and fov_loss's
    reductions: a
    zeroed int that each launch leaves at zero again."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
        raise ValueError(f"the loss scale must be one float32, got {t}")
    return t.data_ptr() if t is not None else None


def _on_cpu(name: str, *tensors) -> bool:
    """Checks devices (and contiguity on the card); True for the CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors
                                      if t is not None):
        raise ValueError(f"{name} takes contiguous tensors")
    return dev.type == "cpu"


def _canvas(name: str, t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if t.dim() == 5 and t.shape[-1] == 1:
        t = t[..., 0]
    if t.dim() != 4 or t.dtype != dtype:
        raise ValueError(f"{name}: want a (B, z, y, x[, 1]) {dtype} canvas, "
                         f"got {tuple(t.shape)} {t.dtype}")
    return t


def _start(shape, off, size):
    """The crop start of a box of `size` centred at shape//2 + off."""
    return clamp_start([s // 2 + o - z // 2 for s, o, z in
                        zip(shape, off, size)], shape, size)


def _box(start, size):
    return (slice(None),) + tuple(slice(s, s + z) for s, z in
                                  zip(start, size))


# -- train_prep ---------------------------------------------------------------

def train_prep_plain(image_u8, lom_u8, canvas_zyx, mean, stddev, soft,
                     pad_logit, init_logit):
    # A tensor divisor: torch divides by a Python scalar as a product with
    # its reciprocal, the kernel and the JAX package truly divide.
    images = (image_u8.to(torch.float32) - mean) / torch.tensor(
        float(np.float32(stddev)), device=image_u8.device)
    hi = torch.tensor(np.float32(1.0 - soft), device=lom_u8.device)
    lo = torch.tensor(np.float32(soft), device=lom_u8.device)
    labels = torch.where(lom_u8 > 0, hi, lo)
    b = image_u8.shape[0]
    seeds = torch.full((b, *canvas_zyx), float(np.float32(pad_logit)),
                       dtype=torch.float32, device=image_u8.device)
    seeds[(slice(None),) + tuple(s // 2 for s in canvas_zyx)] = float(
        np.float32(init_logit))
    return images, labels, seeds


def train_prep(image_u8: torch.Tensor, lom_u8: torch.Tensor,
               canvas_zyx: Sequence[int], mean: float, stddev: float,
               soft: float, pad_logit: float, init_logit: float):
    """(images, labels, seeds) canvases from the uint8 image and mask."""
    image_u8 = _canvas(PREP, image_u8, torch.uint8)
    lom_u8 = _canvas(PREP, lom_u8, torch.uint8)
    canvas_zyx = tuple(int(v) for v in canvas_zyx)
    if _on_cpu(PREP, image_u8, lom_u8):
        return train_prep_plain(image_u8, lom_u8, canvas_zyx, mean, stddev,
                                soft, pad_logit, init_logit)
    b = image_u8.shape[0]
    dev = image_u8.device
    images = torch.empty(image_u8.shape, dtype=torch.float32, device=dev)
    labels = torch.empty(lom_u8.shape, dtype=torch.float32, device=dev)
    seeds = torch.empty((b, *canvas_zyx), dtype=torch.float32, device=dev)
    err = _build.lib().ffn_train_prep(
        image_u8.data_ptr(), lom_u8.data_ptr(), images.data_ptr(),
        labels.data_ptr(), seeds.data_ptr(), image_u8.numel(),
        lom_u8.numel(), b, *canvas_zyx, float(mean), float(stddev),
        float(np.float32(1.0 - soft)), float(np.float32(soft)),
        float(pad_logit), float(init_logit), _stream(image_u8))
    _build.check(err, PREP)
    _build.launches[PREP] += 1
    return images, labels, seeds


# -- train_gather -------------------------------------------------------------

def shell_zyx(deltas_zyx: Sequence[int]) -> np.ndarray:
    """(Nh, 3) points of the delta shell about the centre (fixed_window)."""
    d = np.maximum(np.array(deltas_zyx, np.int64), 0)
    hz, hy, hx = np.meshgrid(*(np.arange(-v, v + 1) for v in d),
                             indexing="ij")
    on_shell = ((np.abs(hz) == d[0]) | (np.abs(hy) == d[1])
                | (np.abs(hx) == d[2]))
    return np.stack([hz[on_shell], hy[on_shell], hx[on_shell]], axis=1)


def _centre_value(canvas, off):
    pos = clamp_start([s // 2 + o for s, o in zip(canvas.shape[1:], off)],
                      canvas.shape[1:], (1, 1, 1))
    return canvas[(slice(None),) + tuple(pos)]


def _window_any(canvas, off, level, shell, radius):
    pts = np.array([s // 2 for s in canvas.shape[1:]])[None, :] + shell
    vals = canvas[:, pts[:, 0], pts[:, 1], pts[:, 2]]
    in_window = np.all(np.abs(shell - np.array(off)[None, :]) <= radius,
                       axis=1)
    mask = torch.from_numpy(in_window).to(canvas.device)
    return ((vals >= level) & mask[None, :]).any(dim=1)


def train_gather_plain(seeds, images, labels, off, fov_zyx, move_t, label_t,
                       window=None):
    valid = _centre_value(seeds, off) >= move_t
    wanted = _centre_value(labels, off) >= label_t
    if window is not None and any(off):
        radius, deltas_zyx = window
        shell = shell_zyx(deltas_zyx)
        valid = _window_any(seeds, off, move_t, shell, radius)
        wanted = _window_any(labels, off, label_t, shell, radius)
    seed_patch = seeds[_box(_start(seeds.shape[1:], off, fov_zyx), fov_zyx)]
    img_patch = images[_box(_start(images.shape[1:], off, fov_zyx),
                            fov_zyx)]
    x_in = torch.stack([img_patch, seed_patch], dim=-1).contiguous()
    return x_in, seed_patch[..., None].contiguous(), valid, wanted


def train_gather(seeds: torch.Tensor, images: torch.Tensor,
                 labels: torch.Tensor, off: Sequence[int],
                 fov_zyx: Sequence[int], move_t: float, label_t: float,
                 window: Optional[tuple] = None):
    """(x_in (B, f^3, 2), seed_patch (B, f^3, 1), valid (B,), wanted (B,))
    at offset `off` (zyx). `window` = (radius, deltas_zyx) selects the
    fixed_window test for every offset but the centre."""
    seeds, images, labels = (_canvas(GATHER, t) for t in
                             (seeds, images, labels))
    off = tuple(int(v) for v in off)
    fov_zyx = tuple(int(v) for v in fov_zyx)
    if _on_cpu(GATHER, seeds, images, labels):
        return train_gather_plain(seeds, images, labels, off, fov_zyx,
                                  move_t, label_t, window)
    b = seeds.shape[0]
    dev = seeds.device
    x_in = torch.empty((b, *fov_zyx, 2), dtype=torch.float32, device=dev)
    seed_patch = torch.empty((b, *fov_zyx, 1), dtype=torch.float32,
                             device=dev)
    valid = torch.empty((b,), dtype=torch.bool, device=dev)
    wanted = torch.empty((b,), dtype=torch.bool, device=dev)
    s, im, lab = (tuple(t.shape[1:]) for t in (seeds, images, labels))
    radius, deltas = window if window is not None else (0, (0, 0, 0))
    dims = (s + im + lab + fov_zyx + _start(s, off, fov_zyx)
            + _start(im, off, fov_zyx)
            + clamp_start([v // 2 + o for v, o in zip(s, off)], s, (1,) * 3)
            + clamp_start([v // 2 + o for v, o in zip(lab, off)], lab,
                          (1,) * 3)
            + tuple(v // 2 for v in s) + tuple(v // 2 for v in lab) + off
            + tuple(max(int(v), 0) for v in deltas))
    arr, addr = _build.host_array(ctypes.c_int, dims)
    err = _build.lib().ffn_train_gather(
        seeds.data_ptr(), images.data_ptr(), labels.data_ptr(),
        x_in.data_ptr(), seed_patch.data_ptr(), valid.data_ptr(),
        wanted.data_ptr(), b, addr, int(window is not None), int(radius),
        float(move_t), float(label_t), _stream(seeds))
    del arr
    _build.check(err, GATHER)
    _build.launches[GATHER] += 1
    return x_in, seed_patch, valid, wanted


# -- train_loss ---------------------------------------------------------------

def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross entropy (train_lib.sigmoid_ce)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def train_loss_plain(logits, seeds, labels, weights, valid, wanted, off,
                     metrics, scale=None):
    b = logits.shape[0]
    fov = tuple(logits.shape[1:4])
    x = logits[..., 0]
    box = _box(_start(labels.shape[1:], off, fov), fov)
    z = labels[box]
    w = weights[box] if weights is not None else torch.ones_like(z)
    valid_f = valid.to(torch.float32)
    active = valid_f.sum()
    denom = torch.clamp(active, min=1.0)
    per_lane = (sigmoid_ce(x, z) * w).mean(dim=(1, 2, 3))
    # An invalid lane adds nothing to the loss, even a NaN (the JAX step
    # reports it so); its gradient below still carries it (0 * NaN).
    loss = torch.where(valid, per_lane, torch.zeros((), device=x.device)
                       ).sum() / denom
    coef = (valid_f / denom) / float(np.prod(fov))
    # jax.grad of sigmoid_ce at x = 0 exactly is -z (as fov_loss_plain).
    sig = torch.where(x == 0, torch.zeros((), device=x.device),
                      torch.sigmoid(x))
    dlogits = (coef.view(b, 1, 1, 1) * w) * (sig - z)
    if scale is not None:
        dlogits = dlogits * scale
    wbox = _box(_start(seeds.shape[1:], off, fov), fov)
    keep = valid.view(b, 1, 1, 1)
    seeds[wbox] = torch.where(keep, x, seeds[wbox])
    metrics.copy_(torch.stack([
        loss, active, (valid & wanted).sum().to(torch.float32),
        (wanted & ~valid).sum().to(torch.float32),
        (valid & ~wanted).sum().to(torch.float32)]))
    return dlogits[..., None].contiguous()


def train_loss(logits: torch.Tensor, seeds: torch.Tensor,
               labels: torch.Tensor, weights: Optional[torch.Tensor],
               valid: torch.Tensor, wanted: torch.Tensor,
               off: Sequence[int], metrics: torch.Tensor,
               ticket: torch.Tensor, scale: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """dloss/dlogits (B, f^3, 1), times `scale` (a 0-d float32 device
    tensor: the loss scale, a power of two) when given; writes the logits of
    valid lanes into `seeds` (in place) and (loss, active, correct, missed,
    spurious) into `metrics` (5 float32, on the device). `ticket`: from
    new_ticket."""
    seeds, labels = _canvas(LOSS, seeds), _canvas(LOSS, labels)
    if weights is not None:
        weights = _canvas(LOSS, weights)
        if weights.shape != labels.shape:
            raise ValueError(f"{LOSS}: weights {tuple(weights.shape)} are "
                             f"not the labels' {tuple(labels.shape)}")
    if logits.dim() != 5 or logits.shape[-1] != 1 or \
            logits.dtype != torch.float32:
        raise ValueError(f"{LOSS}: want (B, z, y, x, 1) float32 logits")
    if metrics.shape != (len(METRICS),) or metrics.dtype != torch.float32:
        raise ValueError(f"{LOSS}: metrics must be {len(METRICS)} float32")
    off = tuple(int(v) for v in off)
    if _on_cpu(LOSS, logits, seeds, labels, weights, valid, wanted,
               metrics, scale):
        return train_loss_plain(logits, seeds, labels, weights, valid,
                                wanted, off, metrics, scale)
    b = logits.shape[0]
    fov = tuple(logits.shape[1:4])
    vox = int(np.prod(fov))
    chunks = -(-vox // LOSS_CHUNK)
    dlogits = torch.empty_like(logits)
    partial = torch.empty((b * chunks,), dtype=torch.float32,
                          device=logits.device)
    s, lab = tuple(seeds.shape[1:]), tuple(labels.shape[1:])
    dims = fov + s + lab + _start(s, off, fov) + _start(lab, off, fov)
    arr, addr = _build.host_array(ctypes.c_int, dims)
    err = _build.lib().ffn_train_loss(
        logits.data_ptr(), seeds.data_ptr(), labels.data_ptr(),
        weights.data_ptr() if weights is not None else None,
        valid.data_ptr(), wanted.data_ptr(), dlogits.data_ptr(),
        partial.data_ptr(), ticket.data_ptr(), metrics.data_ptr(),
        _ptr(scale), b, addr, LOSS_CHUNK, _stream(logits))
    del arr
    _build.check(err, LOSS)
    _build.launches[LOSS] += 1
    return dlogits


# -- train_eval ---------------------------------------------------------------

def train_eval_plain(seeds, labels, eval_zyx):
    def centre(t):
        return t[_box([(v - e) // 2 for v, e in zip(t.shape[1:], eval_zyx)],
                      eval_zyx)]
    lab, logit = centre(labels), centre(seeds)
    pred, truth = logit > 0.0, lab > 0.5
    counts = torch.stack([(pred & truth).sum(), (pred & ~truth).sum(),
                          (~pred & truth).sum(), (~pred & ~truth).sum()])
    return sigmoid_ce(logit, lab).mean(), counts.to(torch.int32)


def train_eval(seeds: torch.Tensor, labels: torch.Tensor,
               eval_zyx: Sequence[int], ticket: torch.Tensor):
    """(patch_loss (), counts (4,) int32: tp, fp, fn, tn) of the centre
    crop of size `eval_zyx`, on the device. `ticket`: from new_ticket."""
    seeds, labels = _canvas(EVAL, seeds), _canvas(EVAL, labels)
    eval_zyx = tuple(int(v) for v in eval_zyx)
    if _on_cpu(EVAL, seeds, labels):
        return train_eval_plain(seeds, labels, eval_zyx)
    b = seeds.shape[0]
    n = b * int(np.prod(eval_zyx))
    blocks = -(-n // EVAL_CHUNK)
    dev = seeds.device
    partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    ipartial = torch.empty((blocks, 4), dtype=torch.int32, device=dev)
    patch_loss = torch.empty((), dtype=torch.float32, device=dev)
    counts = torch.empty((4,), dtype=torch.int32, device=dev)
    s, lab = tuple(seeds.shape[1:]), tuple(labels.shape[1:])
    dims = (s + lab + eval_zyx
            + tuple((v - e) // 2 for v, e in zip(s, eval_zyx))
            + tuple((v - e) // 2 for v, e in zip(lab, eval_zyx)))
    arr, addr = _build.host_array(ctypes.c_int, dims)
    err = _build.lib().ffn_train_eval(
        seeds.data_ptr(), labels.data_ptr(), partial.data_ptr(),
        ipartial.data_ptr(), ticket.data_ptr(), patch_loss.data_ptr(),
        counts.data_ptr(), b, addr, EVAL_CHUNK, _stream(seeds))
    del arr
    _build.check(err, EVAL)
    _build.launches[EVAL] += 1
    return patch_loss, counts


# -- fov_loss (K16) ----------------------------------------------------------

def fov_loss_plain(logits, labels, weights, scale=None):
    # A tensor divisor: torch divides by a Python scalar as a product with
    # its reciprocal, the kernel and the JAX package truly divide.
    n = torch.tensor(float(logits.numel()), device=logits.device)
    loss = (sigmoid_ce(logits, labels) * weights).sum() / n
    sig = torch.where(logits == 0, torch.zeros((), device=logits.device),
                      torch.sigmoid(logits))
    dlogits = (weights / n) * (sig - labels)
    return (dlogits * scale if scale is not None else dlogits), loss


def fov_loss(logits: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor, ticket: torch.Tensor,
             scale: Optional[torch.Tensor] = None):
    """(dloss/dlogits, loss) of loss = mean(sigmoid_ce(logits, labels) *
    weights) over all voxels: (B, z, y, x, 1) float32 tensors of one shape
    in; the gradient of that shape (times `scale`, as train_loss's) and a
    0-d loss, on the device, out. `ticket`: from new_ticket."""
    for t in (logits, labels, weights):
        if t.dim() != 5 or t.shape[-1] != 1 or t.dtype != torch.float32 \
                or t.shape != logits.shape:
            raise ValueError(f"{FOV_LOSS}: want (B, z, y, x, 1) float32 "
                             f"tensors of one shape, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if _on_cpu(FOV_LOSS, logits, labels, weights, ticket, scale):
        return fov_loss_plain(logits, labels, weights, scale)
    n = logits.numel()
    dev = logits.device
    dlogits = torch.empty_like(logits)
    partial = torch.empty((-(-n // FOV_CHUNK),), dtype=torch.float32,
                          device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().ffn_fov_loss(
        logits.data_ptr(), labels.data_ptr(), weights.data_ptr(),
        dlogits.data_ptr(), partial.data_ptr(), ticket.data_ptr(),
        loss.data_ptr(), _ptr(scale), n, FOV_CHUNK, _stream(logits))
    _build.check(err, FOV_LOSS)
    _build.launches[FOV_LOSS] += 1
    return dlogits, loss
