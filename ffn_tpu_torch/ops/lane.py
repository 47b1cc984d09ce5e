"""K7 `lane_threshold`: the thresholded reads of lane seed buffers that host
finalization makes.

Two entry points of one kernel source, `csrc/lane.cu`:

  lane_verdicts  HopEngine.lane_verdicts (ffn_tpu/inference/hop_engine.py
                 :1209-1245): per lane, the count of unclaimed voxels at or
                 above the segment threshold, and whether its origin is at
                 or above the move threshold;
  lane_mask      the device part of FloodFillEngine.lane_mask_region
                 (ffn_tpu/inference/engine.py:446-487): the uint8 mask of a
                 box of one lane, and its origin's verdict.

NaN (unvisited) thresholds to False. On CUDA tensors they launch the
kernels; on CPU tensors the plain PyTorch versions beside them run.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops.hop import BLOCKED_CLAIMED

NAME = "lane_threshold"


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(value)), dtype=torch.float32,
                        device=device)


def _check(seeds, *ints):
    if seeds.dtype != torch.float32 or seeds.dim() != 4:
        raise ValueError(f"{NAME} takes (B,Z,Y,X) float32 seeds, got "
                         f"{seeds.dtype} {tuple(seeds.shape)}")
    if seeds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {seeds.device}")
    for t in ints:
        if t.device != seeds.device:
            raise ValueError(f"{NAME}: tensors on {t.device} and "
                             f"{seeds.device}")
        if seeds.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{NAME} takes contiguous tensors")


def lane_verdicts_plain(seeds, sv, start, blocked, *, segment_threshold,
                        move_threshold):
    dev = seeds.device
    lanes = torch.arange(seeds.shape[0], device=dev)
    seg_t = _f32(segment_threshold, dev)
    counts = torch.stack([
        ((seeds[b] >= seg_t) & ((blocked[int(k)] & BLOCKED_CLAIMED) == 0)
         ).sum(dtype=torch.int32)
        for b, k in enumerate(sv.tolist())]) if len(lanes) else \
        torch.zeros((0,), dtype=torch.int32, device=dev)
    s = start.long()
    ok = seeds[lanes, s[:, 0], s[:, 1], s[:, 2]] >= _f32(move_threshold, dev)
    return counts, ok


def lane_verdicts(seeds: torch.Tensor, sv: torch.Tensor, start: torch.Tensor,
                  blocked: torch.Tensor, *, segment_threshold: float,
                  move_threshold: float):
    """K7 verdicts. seeds (B,Z,Y,X) f32, sv (B,) and start (B,3) int32,
    blocked (K,Z,Y,X) uint8. Returns (counts (B,) int32, ok (B,) bool)."""
    _check(seeds, sv, start, blocked)
    if blocked.dtype != torch.uint8 or tuple(blocked.shape[1:]) != tuple(
            seeds.shape[1:]):
        raise ValueError(f"{NAME}: blocked {blocked.dtype} "
                         f"{tuple(blocked.shape)} for seeds "
                         f"{tuple(seeds.shape)}")
    if seeds.device.type == "cpu":
        return lane_verdicts_plain(seeds, sv, start, blocked,
                                   segment_threshold=segment_threshold,
                                   move_threshold=move_threshold)
    if not seeds.is_contiguous():
        raise ValueError(f"{NAME} takes contiguous tensors")
    B = seeds.shape[0]
    counts = torch.zeros((B,), dtype=torch.int32, device=seeds.device)
    ok = torch.empty((B,), dtype=torch.bool, device=seeds.device)
    if B == 0:
        return counts, ok
    err = _build.lib().ffn_lane_verdicts(
        seeds.data_ptr(), sv.data_ptr(), start.data_ptr(), blocked.data_ptr(),
        counts.data_ptr(), ok.data_ptr(), B, *seeds.shape[1:],
        float(segment_threshold), float(move_threshold),
        torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[NAME] += 1
    return counts, ok


def lane_mask_plain(seeds, lane, start, size, origin, *, threshold,
                    move_threshold):
    box = tuple(slice(int(s), int(s) + int(n)) for s, n in zip(start, size))
    region = seeds[int(lane)][box]
    mask = (region >= _f32(threshold, seeds.device)).to(torch.uint8)
    ok = seeds[(int(lane),) + tuple(int(v) for v in origin)] >= _f32(
        move_threshold, seeds.device)
    return mask, ok.reshape(1)


def lane_mask(seeds: torch.Tensor, lane: int, start: Sequence[int],
              size: Sequence[int], origin: Sequence[int], *,
              threshold: float, move_threshold: float):
    """K7 mask: (seeds[lane][box] >= threshold) as uint8 for the box at
    `start` of `size` (in bounds), and (1,) bool: seeds[lane][origin] >=
    move_threshold."""
    _check(seeds)
    if any(int(s) < 0 or int(s) + int(n) > d or int(n) < 1
           for s, n, d in zip(start, size, seeds.shape[1:])):
        raise ValueError(f"{NAME}: box at {tuple(start)} of {tuple(size)} "
                         f"outside {tuple(seeds.shape[1:])}")
    if seeds.device.type == "cpu":
        return lane_mask_plain(seeds, lane, start, size, origin,
                               threshold=threshold,
                               move_threshold=move_threshold)
    if not seeds.is_contiguous():
        raise ValueError(f"{NAME} takes contiguous tensors")
    mask = torch.empty(tuple(int(n) for n in size), dtype=torch.uint8,
                       device=seeds.device)
    ok = torch.empty((1,), dtype=torch.bool, device=seeds.device)
    err = _build.lib().ffn_lane_mask(
        seeds.data_ptr(), mask.data_ptr(), ok.data_ptr(), int(lane),
        *seeds.shape[1:], *(int(v) for v in start), *(int(v) for v in size),
        *(int(v) for v in origin), float(threshold), float(move_threshold),
        torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[NAME] += 1
    return mask, ok
