"""K2 `step_gather` and K3 `step_update`: both ends of one FFN step, the
non-model parts of `FloodFillEngine._step_impl`/`_apply_model`
(ffn_tpu/inference/engine.py:88-136). CUDA tensors launch `csrc/step.cu`;
CPU tensors the plain versions, the kernels' oracles. Starts follow
`lax.dynamic_(update_)slice`: a negative start wraps once, then clamps
into [0, shape - size].

With bfloat16 seeds (FFN_TPU_SEED_DTYPE=bf16) K2 pads NaN with the pad
rounded to bfloat16 (engine.py:93); K3's disco mask compares the stored
seed with float32 logits (:118), its write-back rounds (:135), the patch
it returns is unrounded (:136). Launches "<name>_bf16"; the dtype of the
seed tensor picks the instantiation (a serial restore is float32).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops.hop import SEED_DTYPES, bf16_round, is_bf16, launch_name

Int3 = Tuple[int, int, int]


def clamp_start(start: Sequence[int], shape: Sequence[int],
                size: Sequence[int]) -> Int3:
    """The start that lax.dynamic_slice uses for a box of `size`."""
    return tuple(min(max(int(s) + (int(n) if s < 0 else 0), 0),
                     int(n) - int(z))
                 for s, n, z in zip(start, shape, size))


def _box(start: Int3, size: Sequence[int]):
    return tuple(slice(s, s + int(z)) for s, z in zip(start, size))


def _check_volume(name, seed, *tensors):
    """float32 (Z,Y,X) tensors on one device; `seed` float32 or bfloat16."""
    tensors = (seed,) + tensors
    for t in tensors:
        dtypes = SEED_DTYPES if t is seed else (torch.float32,)
        if t.dim() != 3 or t.dtype not in dtypes:
            raise ValueError(f"{name} takes (Z,Y,X) volumes, float32 (a seed "
                             f"float32 or bfloat16), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")


def _check_fits(name, shape, *sizes):
    for size in sizes:
        if any(int(z) > int(n) or int(z) < 1 for z, n in zip(size, shape)):
            raise ValueError(f"{name}: patch {tuple(size)} does not fit the "
                             f"volume {tuple(shape)}")


# -- K2 ----------------------------------------------------------------------

GATHER = "step_gather"


def step_gather_plain(image, seed, pos, image_size, seed_size, pad):
    img_start = clamp_start([p - s // 2 for p, s in zip(pos, image_size)],
                            image.shape, image_size)
    seed_start = clamp_start([p - s // 2 for p, s in zip(pos, seed_size)],
                             seed.shape, seed_size)
    image_patch = image[_box(img_start, image_size)].contiguous()
    seed_patch = seed[_box(seed_start, seed_size)].float()
    pad = bf16_round(pad) if is_bf16(seed) else pad
    seed_in = torch.where(torch.isnan(seed_patch),
                          torch.tensor(pad, dtype=torch.float32,
                                       device=seed.device),
                          seed_patch).contiguous()
    return image_patch, seed_in


def step_gather(image: torch.Tensor, seed: torch.Tensor, pos: Sequence[int],
                image_size: Sequence[int], seed_size: Sequence[int],
                pad: float):
    """K2: (image_patch, seed_in) at `pos`; NaN seed voxels become `pad`
    (rounded to bf16 for bf16 seeds).

    image is (Z,Y,X) float32, seed (Z,Y,X) float32 or bfloat16; sizes are
    zyx; each patch starts at pos - size // 2, clamped into the volume. Both
    patches are float32.
    """
    _check_volume(GATHER, seed, image)
    if image.shape != seed.shape:
        raise ValueError(f"{GATHER}: image {tuple(image.shape)} and seed "
                         f"{tuple(seed.shape)} differ")
    _check_fits(GATHER, image.shape, image_size, seed_size)
    if image.device.type == "cpu":
        return step_gather_plain(image, seed, pos, image_size, seed_size, pad)
    if not (image.is_contiguous() and seed.is_contiguous()):
        raise ValueError(f"{GATHER} takes contiguous tensors")
    image_patch = torch.empty(tuple(image_size), device=image.device,
                              dtype=torch.float32)
    seed_in = torch.empty(tuple(seed_size), device=image.device,
                          dtype=torch.float32)
    err = _build.lib().ffn_step_gather(
        image.data_ptr(), seed.data_ptr(), image_patch.data_ptr(),
        seed_in.data_ptr(), *image.shape, *(int(p) for p in pos),
        *(int(s) for s in image_size), *(int(s) for s in seed_size),
        bf16_round(pad) if is_bf16(seed) else float(pad), int(is_bf16(seed)),
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(err, GATHER)
    _build.launches[launch_name(GATHER, seed)] += 1
    return image_patch, seed_in


# -- K3 ----------------------------------------------------------------------

UPDATE = "step_update"


def _update_boxes(pos, shape, seed_size, pred_size):
    """(start of `old`, write start): engine.py:129-134.

    `old` is read from the clamped seed patch; the write start is the
    unclamped seed start plus the pred delta, clamped on its own.
    """
    delta = [(s - p) // 2 for s, p in zip(seed_size, pred_size)]
    seed_start = [p - s // 2 for p, s in zip(pos, seed_size)]
    old_start = tuple(c + d for c, d in zip(
        clamp_start(seed_start, shape, seed_size), delta))
    write_start = clamp_start([s + d for s, d in zip(seed_start, delta)],
                              shape, pred_size)
    return delta, old_start, write_start


def step_update_plain(logits, seed, pos, pred_size, move_threshold,
                      disco_threshold):
    delta, old_start, write_start = _update_boxes(pos, seed.shape,
                                                  logits.shape, pred_size)
    crop = logits[_box(tuple(delta), pred_size)]
    old = seed[_box(old_start, pred_size)].float()
    # jnp.mean of the 0/1 vector: an exact f32 count over one f32 division.
    count = int((crop >= float(np.float32(move_threshold))).sum())
    frac = np.float32(count) / np.float32(crop.numel())
    disco = np.float32(disco_threshold)
    apply = bool(disco >= 0 and frac > disco)
    keep = (old < 0) & (crop > old) if apply else torch.zeros_like(
        crop, dtype=torch.bool)
    patch = torch.where(keep, old, crop)
    seed[_box(write_start, pred_size)] = patch.to(seed.dtype)
    return patch


def step_update(logits: torch.Tensor, seed: torch.Tensor, pos: Sequence[int],
                pred_size: Sequence[int], move_threshold: float,
                disco_threshold: float) -> torch.Tensor:
    """K3: crop, disco mask and write-back of one step; returns the patch.

    logits is the model's float32 (fz,fy,fx) output at the seed patch around
    `pos`; `seed` (Z,Y,X) float32 or bfloat16 is updated in place (rounded
    to nearest even for bfloat16). The returned float32 patch is unrounded.
    disco_threshold < 0 disables the keep-old mask.
    """
    _check_volume(UPDATE, seed, logits)
    _check_fits(UPDATE, seed.shape, logits.shape)
    _check_fits(UPDATE, logits.shape, pred_size)
    if seed.device.type == "cpu":
        return step_update_plain(logits, seed, pos, pred_size,
                                 move_threshold, disco_threshold)
    if not (logits.is_contiguous() and seed.is_contiguous()):
        raise ValueError(f"{UPDATE} takes contiguous tensors")
    patch = torch.empty(tuple(pred_size), device=seed.device,
                        dtype=torch.float32)
    err = _build.lib().ffn_step_update(
        logits.data_ptr(), seed.data_ptr(), patch.data_ptr(), *seed.shape,
        *(int(p) for p in pos), *logits.shape, *(int(s) for s in pred_size),
        float(move_threshold), float(disco_threshold), int(is_bf16(seed)),
        torch.cuda.current_stream(seed.device).cuda_stream)
    _build.check(err, UPDATE)
    _build.launches[launch_name(UPDATE, seed)] += 1
    return patch
