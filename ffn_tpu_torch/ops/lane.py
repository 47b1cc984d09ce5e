"""K7 `lane_threshold`: the thresholded reads of lane seed buffers that host
finalization makes (`csrc/lane.cu`): `lane_verdicts` (hop_engine.py
:1209-1245: per lane the unclaimed voxels at or above the segment
threshold and the origin's move verdict), `lane_mask` (engine.py:446-487:
one box's uint8 mask and verdict), `lane_masks` (engine.py:489-552: N
boxes packed into one buffer, launches "lane_masks"). NaN thresholds to
False. With bfloat16 seeds both thresholds round to bfloat16 first, as
`thr.astype(seed.dtype)` (hop_engine.py:1232-1235, engine.py:475-478,
:533-536); launches "<name>_bf16". CUDA tensors launch the kernels, CPU
tensors run the plain versions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops.hop import (BLOCKED_CLAIMED, SEED_DTYPES, bf16_round,
                                   is_bf16, launch_name)

NAME = "lane_threshold"
MASKS = "lane_masks"


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(value)), dtype=torch.float32,
                        device=device)


def _check(seeds, *ints):
    if seeds.dtype not in SEED_DTYPES or seeds.dim() != 4:
        raise ValueError(f"{NAME} takes (B,Z,Y,X) float32 or bfloat16 "
                         f"seeds, got {seeds.dtype} {tuple(seeds.shape)}")
    if seeds.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {seeds.device}")
    for t in ints:
        if t.device != seeds.device:
            raise ValueError(f"{NAME}: tensors on {t.device} and "
                             f"{seeds.device}")
        if seeds.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{NAME} takes contiguous tensors")


def _thresholds(seeds, *values):
    """The thresholds as the comparisons take them: float32, rounded to
    bfloat16 for bfloat16 seeds."""
    return [bf16_round(v) if is_bf16(seeds) else float(np.float32(v))
            for v in values]


def lane_verdicts_plain(seeds, sv, start, blocked, *, segment_threshold,
                        move_threshold):
    dev = seeds.device
    lanes = torch.arange(seeds.shape[0], device=dev)
    seg_t, move_t = (_f32(v, dev) for v in _thresholds(
        seeds, segment_threshold, move_threshold))
    counts = torch.stack([
        ((seeds[b].float() >= seg_t)
         & ((blocked[int(k)] & BLOCKED_CLAIMED) == 0)
         ).sum(dtype=torch.int32)
        for b, k in enumerate(sv.tolist())]) if len(lanes) else \
        torch.zeros((0,), dtype=torch.int32, device=dev)
    s = start.long()
    ok = seeds[lanes, s[:, 0], s[:, 1], s[:, 2]].float() >= move_t
    return counts, ok


def lane_verdicts(seeds: torch.Tensor, sv: torch.Tensor, start: torch.Tensor,
                  blocked: torch.Tensor, *, segment_threshold: float,
                  move_threshold: float):
    """K7 verdicts. seeds (B,Z,Y,X) f32 or bf16, sv (B,) and start (B,3) int32,
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
        *_thresholds(seeds, segment_threshold, move_threshold),
        int(is_bf16(seeds)),
        torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[launch_name(NAME, seeds)] += 1
    return counts, ok


def lane_mask_plain(seeds, lane, start, size, origin, *, threshold,
                    move_threshold):
    box = tuple(slice(int(s), int(s) + int(n)) for s, n in zip(start, size))
    thr, move_t = (_f32(v, seeds.device) for v in _thresholds(
        seeds, threshold, move_threshold))
    region = seeds[int(lane)][box].float()
    mask = (region >= thr).to(torch.uint8)
    ok = seeds[(int(lane),) + tuple(int(v) for v in origin)].float() >= move_t
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
        *(int(v) for v in origin),
        *_thresholds(seeds, threshold, move_threshold), int(is_bf16(seeds)),
        torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[launch_name(NAME, seeds)] += 1
    return mask, ok


def _box_table(lanes, starts, sizes, origins):
    """(N, 10) int64 rows [lane, start, size, origin] and each box's first
    byte in the packed output; returns (table, offsets, total)."""
    table = np.concatenate([
        np.asarray(lanes, np.int64).reshape(-1, 1),
        np.asarray(starts, np.int64).reshape(-1, 3),
        np.asarray(sizes, np.int64).reshape(-1, 3),
        np.asarray(origins, np.int64).reshape(-1, 3)], axis=1)
    vols = np.prod(table[:, 4:7], axis=1)
    offsets = np.concatenate([[0], np.cumsum(vols)[:-1]]).astype(np.int64)
    return table, offsets, int(vols.sum())


def lane_masks_plain(seeds, lanes, starts, sizes, origins, *, threshold,
                     move_threshold):
    table, _, _ = _box_table(lanes, starts, sizes, origins)
    masks, oks = [], []
    for row in table.tolist():
        mask, ok = lane_mask_plain(seeds, row[0], row[1:4], row[4:7],
                                   row[7:10], threshold=threshold,
                                   move_threshold=move_threshold)
        masks.append(mask.reshape(-1))
        oks.append(ok.to(torch.uint8))
    return torch.cat(masks + oks)


def lane_masks(seeds: torch.Tensor, lanes, starts, sizes, origins, *,
               threshold: float, move_threshold: float) -> torch.Tensor:
    """K7, batched: for box j of lane lanes[j] at starts[j] of sizes[j] (in
    bounds), (seeds[lane][box] >= threshold) as uint8, and the verdict
    seeds[lane][origins[j]] >= move_threshold. The box arguments are host
    integer arrays (N,) and (N, 3). Returns one uint8 tensor: the N masks
    flattened one after another, then N verdict bytes."""
    _check(seeds)
    table, offsets, total = _box_table(lanes, starts, sizes, origins)
    dims = np.array(seeds.shape[1:])
    if len(table) == 0 or np.any(table[:, 1:4] < 0) or np.any(
            table[:, 4:7] < 1) or np.any(table[:, 1:4] + table[:, 4:7] > dims)\
            or np.any((table[:, 0] < 0) | (table[:, 0] >= seeds.shape[0])):
        raise ValueError(f"{MASKS}: boxes {table[:, :7].tolist()} outside "
                         f"{tuple(seeds.shape)}")
    if seeds.device.type == "cpu":
        return lane_masks_plain(seeds, lanes, starts, sizes, origins,
                                threshold=threshold,
                                move_threshold=move_threshold)
    if not seeds.is_contiguous():
        raise ValueError(f"{MASKS} takes contiguous tensors")
    dev = seeds.device
    table_d = torch.from_numpy(table.astype(np.int32)).to(dev)
    offsets_d = torch.from_numpy(offsets).to(dev)
    out = torch.empty((total + len(table),), dtype=torch.uint8, device=dev)
    err = _build.lib().ffn_lane_masks(
        seeds.data_ptr(), table_d.data_ptr(), offsets_d.data_ptr(),
        out.data_ptr(), len(table), *seeds.shape[1:],
        int(np.prod(table[:, 4:7], axis=1).max()), total,
        *_thresholds(seeds, threshold, move_threshold), int(is_bf16(seeds)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, MASKS)
    _build.launches[launch_name(MASKS, seeds)] += 1
    return out
