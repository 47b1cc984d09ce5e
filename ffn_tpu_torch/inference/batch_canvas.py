"""Batched multi-seed flood-fill canvas, round by round.

Counterpart of ffn_tpu/inference/batch_canvas.py: B lanes advance on one
subvolume. Holds what every batched canvas does on the host (the seed pool
deferring seeds near running lanes, seed validity, lane bookkeeping,
finalization with the verdict order weak -> seed-claimed -> too small ->
segment) and the round-based loop (hops 0): each running lane submits its
FIFO's K front entries, select_step (K13 -> model -> K14) takes the first
valid one, and a round moves one packed array each way. HopBatchCanvas
keeps the FIFOs on the device. Per object the semantics are
Canvas.segment_all's (lanes=1 matches it); as in JAX, overlapping flood
fills see each other's voxels only after a finalization.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
from scipy.special import expit, logit

from ffn_tpu_torch.inference import movement
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.inference.counters import (Counters, TimedIter,
                                               timer_counter)

MSEC_IN_SEC = 1000

_IDLE = 0
_RUNNING = 1


class _SeedPool:
    """Array-backed ordered pool of candidate seed positions.

    Keeps a list-of-(z, y, x)-tuples API (append/iter/len/in) over a
    dense (N, 3) int64 view (`arr`) for the vectorized draw and validation
    paths.
    """

    __slots__ = ("_buf", "_n")

    def __init__(self, items=None):
        if items is None or (hasattr(items, "__len__")
                             and len(items) == 0):
            self._buf = np.zeros((64, 3), np.int64)
            self._n = 0
        else:
            arr = np.asarray(items, np.int64).reshape(-1, 3)
            self._buf = np.ascontiguousarray(arr)
            self._n = len(arr)

    @property
    def arr(self) -> np.ndarray:
        """Dense (N, 3) int64 view of the pool, in insertion order."""
        return self._buf[:self._n]

    def _grow(self, extra: int):
        need = self._n + extra
        if need > len(self._buf):
            cap = max(need, 2 * len(self._buf))
            buf = np.zeros((cap, 3), np.int64)
            buf[:self._n] = self._buf[:self._n]
            self._buf = buf

    def append(self, pos):
        self._grow(1)
        self._buf[self._n] = pos
        self._n += 1

    def replace(self, arr):
        """Replaces the contents with the rows of `arr` (no copy kept)."""
        arr = np.asarray(arr, np.int64).reshape(-1, 3)
        self._buf = np.ascontiguousarray(arr)
        self._n = len(arr)

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def __iter__(self):
        for row in self._buf[:self._n]:
            yield tuple(int(v) for v in row)

    def __contains__(self, pos):
        pos = np.asarray(pos, np.int64)
        return bool(np.any(np.all(self._buf[:self._n] == pos, axis=1)))


class _SpacedAccept:
    """Order-exact greedy spacing filter for one draw phase.

    A candidate conflicts when |cand - p| <= pred on every axis for any
    already-accepted p. Conflicts against the accepts known at construction
    are one vectorized test; accepts made during the phase are checked in
    Python and folded into the vectorized base every 32.
    """

    __slots__ = ("cands", "pred", "base_conf", "new")

    def __init__(self, cands, base, pred):
        self.cands = np.asarray(cands, np.int64).reshape(-1, 3)
        self.pred = tuple(int(v) for v in np.broadcast_to(pred, (3,)))
        self.base_conf = self._conflicts(base)
        self.new = []

    def _conflicts(self, picked) -> np.ndarray:
        picked = np.asarray(picked, np.int64).reshape(-1, 3)
        if not len(picked) or not len(self.cands):
            return np.zeros(len(self.cands), bool)
        pred = np.asarray(self.pred, np.int64)
        return np.any(np.all(
            np.abs(self.cands[:, None, :] - picked[None, :, :]) <= pred,
            axis=2), axis=1)

    def conflicted(self, i: int) -> bool:
        if self.base_conf[i]:
            return True
        cz, cy, cx = (int(v) for v in self.cands[i])
        pz, py, px = self.pred
        for z, y, x in self.new:
            if abs(z - cz) <= pz and abs(y - cy) <= py \
                    and abs(x - cx) <= px:
                return True
        return False

    def accepted(self, pos):
        self.new.append(tuple(int(v) for v in pos))
        if len(self.new) >= 32:
            self.base_conf |= self._conflicts(np.asarray(self.new))
            self.new.clear()


class _Lane:
    __slots__ = ("state", "start_pos", "queue", "done_cells", "min_pos",
                 "max_pos", "num_iters", "t_start", "pending", "spill")

    def __init__(self):
        self.state = _IDLE
        self.start_pos = None
        self.queue = []        # FIFO of (score, (z, y, x))
        self.done_cells = set()
        self.min_pos = None
        self.max_pos = None
        self.num_iters = 0
        self.t_start = 0.0
        self.pending = []      # candidates currently submitted to the device
        self.spill = []        # hop path: host-side queue-overflow spill


class BatchCanvas:
    """Segments a subvolume with B concurrent flood-fill lanes."""

    # HopBatchCanvas keeps its seeds in its lane state: a second (B, Z, Y, X)
    # batch would double the dominant device allocation.
    _allocate_seed_batch = True

    def __init__(self, model_info, engine, image, options, lanes: int = 8,
                 candidates_per_step: int = 4, max_iters_per_segment: int = 0,
                 voxel_size_zyx=(1, 1, 1), counters=None, restrictor=None,
                 corner_zyx=None, keep_probability_maps=False,
                 checkpoint_path=None, checkpoint_interval_sec=0):
        self.engine = engine
        self.image = np.ascontiguousarray(image, dtype=np.float32)
        self.voxel_size_zyx = voxel_size_zyx
        self.lanes = lanes
        self.K = candidates_per_step
        # Safety valve for runaway objects (0 = unlimited, the reference
        # semantics): a lane exceeding this many FFN iterations is
        # finalized with whatever it has filled.
        self.max_iters_per_segment = max_iters_per_segment

        # Probability -> logit space, rounded to float32 as the JAX
        # package's proto fields are.
        self.options = dataclasses.replace(options, **{
            attr: float(logit(getattr(options, attr)))
            for attr in ("init_activation", "pad_value", "move_threshold",
                         "segment_threshold")})

        self.counters = counters if counters is not None else Counters()
        self.corner_zyx = corner_zyx
        self.shape = self.image.shape
        self.restrictor = restrictor if restrictor is not None else \
            movement.MovementRestrictor()

        self._pred_size = np.array(model_info.pred_mask_size[::-1])
        self._input_seed_size = np.array(model_info.input_seed_size[::-1])
        self._input_image_size = np.array(model_info.input_image_size[::-1])
        self.margin = self._input_image_size // 2
        self._deltas_zyx = np.array(model_info.deltas[::-1])

        self.segmentation = np.zeros(self.shape, np.int32)
        self.keep_probability_maps = keep_probability_maps
        self.seg_prob = np.zeros(self.shape, np.uint8) \
            if keep_probability_maps else None

        self._image_dev = self._put_image_dev()
        self._seeds_dev = engine.new_seed_batch(lanes, self.shape) \
            if self._allocate_seed_batch else None
        self._lanes = [_Lane() for _ in range(lanes)]

        self.origins = {}
        self.overlaps = {}
        # Seeds postponed because an active lane was flooding nearby.
        self._deferred = _SeedPool()
        self._max_id = 0
        self.seed_policy = None
        self._seed_policy_state = None
        self.checkpoint_path = checkpoint_path
        self.checkpoint_interval_sec = checkpoint_interval_sec
        self.checkpoint_last = time.time()

    # Seed policies access canvas.segmentation/restrictor/margin/shape/image.

    def _put_image_dev(self):
        """Uploads the subvolume image; the fused driver's slots place it
        into a slot of a shared (K, Z, Y, X) stack instead."""
        return self.engine.put_image(self.image)

    def log_info(self, s, *args):
        logging.info(s, *args)

    def get_next_segment_id(self) -> int:
        self._max_id += 1
        while self._max_id in self.origins:
            self._max_id += 1
        return self._max_id

    # -- seed validity (Canvas.is_valid_pos minus the seed-value check,
    #    which runs on the device) -------------------------------------------

    def _pos_in_bounds(self, pos) -> bool:
        p = np.asarray(pos)
        return bool(np.all(p - self.margin >= 0)
                    and np.all(p + self.margin < self.shape))

    def _host_valid(self, lane: _Lane, pos) -> bool:
        if self._quantize(lane, pos) in lane.done_cells:
            return False
        if not self._pos_in_bounds(pos):
            self.counters["skip_invalid_pos"].Increment()
            return False
        if self.segmentation[tuple(pos)] > 0:
            self.counters["skip_invalid_pos"].Increment()
            return False
        if not self.restrictor.is_valid_pos(tuple(pos)):
            self.counters["skip_restriced_pos"].Increment()
            return False
        return True

    def _quantize(self, lane: _Lane, pos):
        rel = np.asarray(pos) - lane.start_pos
        d = self._deltas_zyx
        return tuple((rel + d // 2) // np.maximum(d, 1))

    def _active_lane_boxes(self):
        """(N, 2, 3) array of [lo, hi] claim bboxes of running lanes."""
        boxes = []
        for lane in self._lanes:
            if lane.state != _RUNNING:
                continue
            boxes.append((lane.min_pos - self._pred_size // 2,
                          lane.max_pos + self._pred_size // 2))
        if not boxes:
            return np.zeros((0, 2, 3), np.int64)
        return np.array(boxes)

    def _near_active(self, positions, boxes) -> np.ndarray:
        """(N,) bool: positions inside any running lane's claim bbox.
        Seeding there would duplicate that lane's flood fill; such seeds
        are deferred until the lane finalizes."""
        if not len(boxes) or not len(positions):
            return np.zeros(len(positions), bool)
        p = np.asarray(positions)[:, None, :]          # (N, 1, 3)
        lo = boxes[None, :, 0, :]                      # (1, L, 3)
        hi = boxes[None, :, 1, :]
        return np.any(np.all((p >= lo) & (p <= hi), axis=2), axis=1)

    def _valid_seed_batch(self, positions: np.ndarray) -> np.ndarray:
        """Vectorized _valid_seed_pos over (N, 3) candidates. The filters
        are independent across candidates, so counters and -1 markers match
        a sequential scan."""
        positions = np.asarray(positions, np.int64).reshape(-1, 3)
        n = len(positions)
        if n == 0:
            return np.zeros(0, bool)
        ok = np.ones(n, bool)

        in_bounds = (np.all(positions - self.margin >= 0, axis=1)
                     & np.all(positions + self.margin < self.shape,
                              axis=1))
        ok &= in_bounds
        idx = tuple(positions[ok].T)
        claimed = np.zeros(n, bool)
        claimed[ok] = self.segmentation[idx] > 0
        self.counters["skip_invalid_pos"].IncrementBy(
            int((~in_bounds).sum() + claimed.sum()))
        ok &= ~claimed

        if ok.any() and (self.restrictor.mask is not None
                         or self.restrictor.seed_mask is not None):
            restricted = np.zeros(n, bool)
            for i in np.flatnonzero(ok):
                p = tuple(positions[i])
                if not (self.restrictor.is_valid_pos(p)
                        and self.restrictor.is_valid_seed(p)):
                    restricted[i] = True
            self.counters["skip_restriced_pos"].IncrementBy(
                int(restricted.sum()))
            ok &= ~restricted

        if ok.any():
            offs = getattr(self, "_mbd_offs", None)
            if offs is None:
                mbd = np.array(self.options.min_boundary_dist)   # zyx
                offs = np.stack(np.meshgrid(
                    *[np.arange(-m, m + 1) for m in mbd],
                    indexing="ij"), axis=-1).reshape(-1, 3)
                self._mbd_offs = offs
            live = np.flatnonzero(ok)
            nb = positions[live][:, None, :] + offs[None, :, :]
            np.clip(nb, 0, np.asarray(self.shape) - 1, out=nb)
            vals = self.segmentation[nb[..., 0], nb[..., 1], nb[..., 2]]
            near = (vals > 0).any(axis=1)
            for i in live[near]:
                self.segmentation[tuple(positions[i])] = -1
            ok[live[near]] = False
        return ok

    def _valid_seed_pos(self, pos) -> bool:
        """Seed-level filters of Canvas.segment_all."""
        if not self._pos_in_bounds(pos):
            self.counters["skip_invalid_pos"].Increment()
            return False
        if self.segmentation[pos] > 0:
            self.counters["skip_invalid_pos"].Increment()
            return False
        if not (self.restrictor.is_valid_pos(pos)
                and self.restrictor.is_valid_seed(pos)):
            self.counters["skip_restriced_pos"].Increment()
            return False
        mbd = np.array(self.options.min_boundary_dist)   # zyx
        low = np.array(pos) - mbd
        high = np.array(pos) + mbd + 1
        sel = tuple(slice(max(int(s), 0), int(e))
                    for s, e in zip(low, high))
        if np.any(self.segmentation[sel] > 0):
            self.segmentation[pos] = -1
            return False
        return True

    # -- checkpointing ---------------------------------------------------------
    # A killed worker resumes the subvolume with every lane's in-flight flood
    # fill intact, in the JAX package's round-based format
    # (batch_canvas.py:413-501), so either package restores the other's.

    def save_checkpoint(self, path: str):
        self.log_info("Saving batch-canvas checkpoint to %s.", path)
        with timer_counter(self.counters, "save_checkpoint"):
            lanes_state = []
            deferred = list(self._deferred)
            for li, lane in enumerate(self._lanes):
                if lane.state != _RUNNING or lane.num_iters <= 0:
                    # A lane without an executed step has no device state
                    # worth saving: its seed goes back to the deferred pool.
                    if lane.state == _RUNNING:
                        deferred.append(tuple(int(v)
                                              for v in lane.start_pos))
                    lanes_state.append(None)
                    continue
                sel_start = np.maximum(
                    lane.min_pos - self._pred_size // 2, 0)
                sel_end = np.minimum(
                    lane.max_pos + self._pred_size // 2 + 1, self.shape)
                region, region_start = self._lane_region(
                    li, sel_start, sel_end - sel_start)
                lanes_state.append({
                    "start_pos": np.asarray(lane.start_pos),
                    "queue": lane.queue,
                    "pending": lane.pending,
                    "done_cells": np.array(sorted(lane.done_cells),
                                           np.int64).reshape(-1, 3),
                    "min_pos": np.asarray(lane.min_pos),
                    "max_pos": np.asarray(lane.max_pos),
                    "num_iters": lane.num_iters,
                    "region": region,
                    "region_start": np.asarray(region_start),
                })
            seed_policy_state = None
            if self.seed_policy is not None:
                seed_policy_state = self.seed_policy.get_state()
            aux = {}
            if self.keep_probability_maps:
                aux["seg_qprob"] = self.seg_prob
            with storage.atomic_file(path) as fd:
                np.savez_compressed(
                    fd,
                    segmentation=self.segmentation,
                    origins=self.origins,
                    overlaps=self.overlaps,
                    deferred=np.array(deferred, np.int64).reshape(-1, 3),
                    lanes=np.asarray(lanes_state, dtype=object),
                    seed_policy_state=np.asarray(seed_policy_state,
                                                 dtype=object),
                    counters=self.counters.dumps_np(),
                    **aux)
        self.log_info("Batch-canvas checkpoint saved.")

    def restore_checkpoint(self, path: str) -> int:
        """Restores a round-based checkpoint; lanes at or above this
        canvas's lane count are skipped, as in the JAX canvas."""
        self.log_info("Restoring batch-canvas checkpoint: %s", path)
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=True)
            self.segmentation[...] = data["segmentation"]
            if self.keep_probability_maps and "seg_qprob" in data:
                self.seg_prob[...] = data["seg_qprob"]
            self.origins = storage._read_origins_entry(path)
            self.overlaps = data["overlaps"].item()
            self._deferred = _SeedPool(data["deferred"])
            self._max_id = int(np.max(self.segmentation, initial=0))
            self._seed_policy_state = data["seed_policy_state"]
            self.counters.loads_np(data["counters"])
            for li, saved in enumerate(data["lanes"]):
                if saved is None or li >= self.lanes:
                    continue
                lane = self._lanes[li]
                lane.state = _RUNNING
                lane.start_pos = np.asarray(saved["start_pos"])
                lane.queue = [(float(s), tuple(int(v) for v in p))
                              for s, p in saved["queue"]]
                lane.pending = [(float(s), tuple(int(v) for v in p))
                                for s, p in saved["pending"]]
                lane.done_cells = {tuple(int(v) for v in row)
                                   for row in saved["done_cells"]}
                lane.min_pos = np.asarray(saved["min_pos"])
                lane.max_pos = np.asarray(saved["max_pos"])
                lane.num_iters = int(saved["num_iters"])
                lane.t_start = time.time()
                self._seeds_dev = self.engine.set_lane_seed_region(
                    self._seeds_dev, li, saved["region_start"],
                    saved["region"])
        self.log_info("Batch-canvas checkpoint restored (%d lanes "
                      "in flight).", sum(1 for lane in self._lanes
                                         if lane.state == _RUNNING))
        return 0

    def _maybe_save_checkpoint(self):
        if self.checkpoint_path is None or \
                self.checkpoint_interval_sec <= 0:
            return
        if time.time() - self.checkpoint_last < self.checkpoint_interval_sec:
            return
        self.save_checkpoint(self.checkpoint_path)
        self.checkpoint_last = time.time()

    # -- seed scheduling (shared with HopBatchCanvas) --------------------------

    def _draw_seeds(self, n: int, seed_iter, seeds_exhausted: bool,
                    relax_threshold: Optional[int] = None):
        """Draws up to n fresh, valid seed positions: retries deferred
        seeds whose region is now free, then draws from the policy.
        Returns (positions, seeds_exhausted).

        relax_threshold: when n exceeds it, deferred seeds are
        speculatively flooded even near active lanes; None disables
        relaxation. Every phase validates its candidates in one vectorized
        pass and resolves seed-vs-seed spacing through _SpacedAccept,
        preserving the sequential accept order exactly."""
        available = []
        if n <= 0:
            return available, seeds_exhausted

        boxes = self._active_lane_boxes()
        # Retry seeds deferred earlier: still-near ones stay deferred, free
        # invalid ones drop, free valid spaced ones are accepted.
        if self._deferred:
            deferred = self._deferred.arr
            near = self._near_active(deferred, boxes)
            valid = np.zeros(len(deferred), bool)
            free = np.flatnonzero(~near)
            if len(free):
                valid[free] = self._valid_seed_batch(deferred[free])
            sp = _SpacedAccept(deferred, available, self._pred_size)
            keep = np.ones(len(deferred), bool)
            near_l, valid_l = near.tolist(), valid.tolist()
            for i in range(len(deferred)):
                if len(available) >= n:
                    break
                if near_l[i] or sp.conflicted(i):
                    continue   # stays deferred
                keep[i] = False
                if valid_l[i]:
                    pos = tuple(int(v) for v in deferred[i])
                    available.append(pos)
                    sp.accepted(pos)
            self._deferred.replace(deferred[keep])
        # Fresh draws from the policy, in chunks sized to the remaining
        # demand, so nothing is drawn ahead and discarded.
        while len(available) < n and not seeds_exhausted:
            want = n - len(available)
            if hasattr(seed_iter, "draw_batch"):
                chunk = seed_iter.draw_batch(want)
                seeds_exhausted = len(chunk) < want
            else:
                chunk = []
                while len(chunk) < want:
                    try:
                        chunk.append(tuple(next(seed_iter)))
                    except StopIteration:
                        seeds_exhausted = True
                        break
            if not len(chunk):
                break
            arr = np.asarray(chunk, np.int64).reshape(-1, 3)
            valid = self._valid_seed_batch(arr)
            near = self._near_active(arr, boxes)
            sp = _SpacedAccept(arr, available, self._pred_size)
            near_l, valid_l = near.tolist(), valid.tolist()
            for i in range(len(arr)):
                if not valid_l[i]:
                    continue
                pos = tuple(int(v) for v in arr[i])
                if near_l[i] or sp.conflicted(i):
                    # A running lane (or a seed picked this round) is
                    # already flooding this region; retry once it
                    # finalizes.
                    self._deferred.append(pos)
                    continue
                available.append(pos)
                sp.accepted(pos)

        # Relaxed deferral: when most lanes would sit idle, flood deferred
        # seeds speculatively; a lane whose seed ends up inside another
        # object's claim is dropped at finalization, so semantics hold.
        if len(available) < n and relax_threshold is not None \
                and n > relax_threshold and self._deferred:
            deferred = self._deferred.arr
            valid = self._valid_seed_batch(deferred)
            sp = _SpacedAccept(deferred, available, self._pred_size)
            keep = np.ones(len(deferred), bool)
            valid_l = valid.tolist()
            for i in range(len(deferred)):
                if len(available) >= n:
                    break
                if sp.conflicted(i):
                    continue   # stays deferred
                keep[i] = False
                if valid_l[i]:
                    pos = tuple(int(v) for v in deferred[i])
                    available.append(pos)
                    sp.accepted(pos)
                    self.counters["relaxed-deferral-seeds"].Increment()
            self._deferred.replace(deferred[keep])
        return available, seeds_exhausted

    def _assign_fresh_seeds(self, seed_iter, seeds_exhausted: bool):
        """Picks seeds for idle lanes; returns
        (assignments [(lane_index, pos_zyx)], seeds_exhausted)."""
        idle = [li for li, lane in enumerate(self._lanes)
                if lane.state == _IDLE]
        available, seeds_exhausted = self._draw_seeds(
            len(idle), seed_iter, seeds_exhausted,
            relax_threshold=self.lanes // 2)
        return list(zip(idle, available)), seeds_exhausted

    def _start_lane(self, li: int, pos) -> _Lane:
        """Initializes the host-side mirror of a fresh lane."""
        lane = self._lanes[li]
        lane.state = _RUNNING
        lane.start_pos = np.array(pos)
        lane.queue = []
        lane.done_cells = set()
        lane.min_pos = np.array(pos)
        lane.max_pos = np.array(pos)
        lane.num_iters = 0
        lane.t_start = time.time()
        lane.pending = []
        lane.spill = []
        self.log_info("lane %d: starting segmentation at %r (zyx)", li,
                      tuple(pos))
        return lane

    # -- main loop -------------------------------------------------------------

    def segment_all(self, seed_policy=seed_lib.PolicyPeaks,
                    partial_segment_iters: int = 0):
        """The round-based main loop (batch_canvas.py:657-793)."""
        del partial_segment_iters  # lane progress is restored per lane
        self.seed_policy = seed_policy(self)
        if self._seed_policy_state is not None:
            self.seed_policy.set_state(self._seed_policy_state)
            self._seed_policy_state = None
        seed_iter = TimedIter(self.seed_policy, self.counters,
                              "seed-policy")
        seeds_exhausted = False

        B, K = self.lanes, self.K
        start_pos = np.zeros((B, 3), np.int32)
        active = np.zeros(B, bool)
        ignore = np.zeros(B, bool)
        candidates = np.zeros((B, K, 3), np.int32)
        safe_pos = np.array(self.margin, np.int32)  # in-bounds dummy

        with timer_counter(self.counters, "segment_all"):
            while True:
                self._maybe_save_checkpoint()
                # 1. Assign fresh seeds to idle lanes.
                reset_mask = np.zeros(B, bool)
                reset_pos = np.zeros((B, 3), np.int32)
                assignments, seeds_exhausted = self._assign_fresh_seeds(
                    seed_iter, seeds_exhausted)
                for li, pos in assignments:
                    lane = self._start_lane(li, pos)
                    lane.pending = [
                        (self.options.move_threshold * 2, tuple(pos))]
                    reset_mask[li] = True
                    reset_pos[li] = pos
                if reset_mask.any():
                    self._seeds_dev = self.engine.reset_lanes(
                        self._seeds_dev, reset_mask, reset_pos,
                        self.options.init_activation)

                # 2. Build the candidate batch.
                for li, lane in enumerate(self._lanes):
                    active[li] = False
                    ignore[li] = False
                    candidates[li] = safe_pos
                    if lane.state != _RUNNING:
                        continue
                    if (self.max_iters_per_segment > 0 and
                            lane.num_iters >= self.max_iters_per_segment):
                        self.counters["iter-cap-hit"].Increment()
                        self._finalize(li, lane)
                        continue
                    # Held-over candidates are re-screened every round, as
                    # the reference checks dedup and claims at pop time
                    # (all but a fresh lane's first entry, its seed).
                    if lane.num_iters > 0:
                        lane.pending = [
                            (s, p) for (s, p) in lane.pending
                            if self._host_valid(lane, p)]
                    while len(lane.pending) < K and lane.queue:
                        score, pos = lane.queue.pop(0)
                        if self._host_valid(lane, pos):
                            lane.pending.append((score, pos))
                    if not lane.pending:
                        # Queue exhausted: the object is complete.
                        self._finalize(li, lane)
                        continue
                    active[li] = True
                    ignore[li] = lane.num_iters == 0
                    start_pos[li] = lane.start_pos
                    for k, (_, pos) in enumerate(lane.pending[:K]):
                        candidates[li, k] = pos
                    for k in range(len(lane.pending), K):
                        candidates[li, k] = lane.pending[-1][1]

                if not active.any():
                    if seeds_exhausted:
                        break
                    continue

                # 3. One device round for all lanes.
                with timer_counter(self.counters, "predict"):
                    self._seeds_dev, aux = self.engine.select_step(
                        self._image_dev, self._seeds_dev, candidates,
                        start_pos, active, ignore)

                # 4. Integrate the results.
                for li, lane in enumerate(self._lanes):
                    if active[li]:
                        self._integrate(li, lane, aux)

        self.log_info("Segmentation done.")

    def _integrate(self, li: int, lane: _Lane, aux):
        """One active lane's round result -> its host FIFO and bookkeeping
        (batch_canvas.py:745-791)."""
        K = self.K
        if not aux["start_ok"][li]:
            self.counters["seed_got_too_weak"].Increment()
            self._finalize(li, lane, weak=True)
            return
        chosen = int(aux["chosen"][li])
        n_pending = min(len(lane.pending), K)
        if chosen < 0 or chosen >= n_pending:
            # All submitted candidates were below the threshold.
            self.counters["skip_threshold"].IncrementBy(n_pending)
            del lane.pending[:n_pending]
            if not lane.pending and not lane.queue:
                self._finalize(li, lane)
            return
        # Candidates before the chosen one failed the threshold.
        self.counters["skip_threshold"].IncrementBy(chosen)
        pos = tuple(int(v) for v in aux["pos"][li])
        del lane.pending[:chosen + 1]
        lane.done_cells.add(self._quantize(lane, pos))
        lane.min_pos = np.minimum(lane.min_pos, pos)
        lane.max_pos = np.maximum(lane.max_pos, pos)
        lane.num_iters += 1
        self.counters["fov-moves"].Increment()

        # Queue the face-max moves by descending score, as the reference
        # sorts them; identical (score, offset) pairs dedup.
        scored = []
        seen = set()
        for f in range(6):
            score = float(aux["scores"][li, f])
            if score < self.options.move_threshold:
                continue
            rel = tuple(int(v) for v in aux["offsets"][li, f])
            item = (score, rel)
            if item in seen:
                continue
            seen.add(item)
            scored.append(item)
        scored.sort(reverse=True)
        for score, rel in scored:
            lane.queue.append(
                (score, tuple(int(rel[i] + pos[i]) for i in range(3))))

    def _lane_region(self, li: int, sel_start, size_zyx):
        """Downloads a sub-box of one lane's POM buffer."""
        return self.engine.lane_seed_region(self._seeds_dev, li, sel_start,
                                            size_zyx)

    def _lane_mask_region(self, li: int, sel_start, size_zyx, start_pos):
        """Thresholded finalization download through K7 (uint8 mask and
        weak-seed verdict; see engine.lane_mask_region)."""
        return self.engine.lane_mask_region(
            self._seeds_dev, li, sel_start, size_zyx,
            self.options.segment_threshold, start_pos)

    def _post_segment(self, sid: int, sel, mask) -> None:
        """Hook called after a new segment id is written (HopBatchCanvas
        mirrors the claim into the device blocked volume)."""

    def _finalize(self, li: int, lane: _Lane, weak: bool = False,
                  too_small: bool = False):
        """Thresholds a finished lane's POM into the shared segmentation.

        weak=True marks a lane the device already rejected (origin below
        the move threshold); too_small=True one whose device-side count
        (engine.lane_verdicts) is below min_segment_size. Both are recorded
        without downloading the POM region; the verdict count is an upper
        bound on the post-masking count, so the outcome matches the full
        path exactly."""
        lane.state = _IDLE
        t_seg = time.time() - lane.t_start
        num_iters = lane.num_iters
        pos = tuple(int(v) for v in lane.start_pos)
        if num_iters <= 0:
            self.counters["invalid-other-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        if weak:
            if self.segmentation[pos] == 0:
                self.segmentation[pos] = -1
            self.log_info("lane %d: failed, weak seed", li)
            self.counters["invalid-weak-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        if self.segmentation[pos] > 0:
            # Another lane finalized an object covering this lane's seed
            # point: under serial ordering this seed would never have
            # started, so the lane is dropped.
            self.log_info("lane %d: seed claimed by segment %d, dropped",
                          li, int(self.segmentation[pos]))
            self.counters["seed-claimed-drops"].Increment()
            self.counters["invalid-other-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        if too_small:
            if self.segmentation[pos] == 0:
                self.segmentation[pos] = -1
            self.log_info("lane %d: failed, too small (device count)",
                          li)
            self.counters["invalid-small-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        # Download only the visited bounding box (bucketed shapes): the
        # f32 logits when probability maps are kept, else K7's uint8 mask.
        sel_start = np.maximum(lane.min_pos - self._pred_size // 2, 0)
        sel_end = np.minimum(lane.max_pos + self._pred_size // 2 + 1,
                             self.shape)
        region = None
        with timer_counter(self.counters, "finalize"):
            if self.keep_probability_maps:
                region, region_start = self._lane_region(
                    li, sel_start, sel_end - sel_start)
                seed_at_start = region[tuple(
                    int(p - r) for p, r in zip(pos, region_start))]
                start_ok = bool(seed_at_start >=
                                self.options.move_threshold)
                with np.errstate(invalid="ignore"):
                    mask_buf = region >= self.options.segment_threshold
            else:
                mask_buf, region_start, start_ok = self._lane_mask_region(
                    li, sel_start, sel_end - sel_start, pos)
                mask_buf = mask_buf > 0

        def region_view(buf, global_sel_start, global_sel_end):
            return buf[tuple(
                slice(int(s - r), int(e - r))
                for s, e, r in zip(global_sel_start, global_sel_end,
                                   region_start))]

        # Weak original seed?
        if not start_ok:
            if self.segmentation[pos] == 0:
                self.segmentation[pos] = -1
            self.log_info("lane %d: failed, weak seed", li)
            self.counters["invalid-weak-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        sel = tuple(slice(int(s), int(e))
                    for s, e in zip(sel_start, sel_end))
        mask = region_view(mask_buf, sel_start, sel_end)
        raw_segmented_voxels = int(np.sum(mask))

        overlapped_ids, counts = np.unique(self.segmentation[sel][mask],
                                           return_counts=True)
        valid = overlapped_ids > 0
        overlapped_ids = overlapped_ids[valid]
        counts = counts[valid]

        mask &= self.segmentation[sel] <= 0
        actual = int(np.sum(mask))
        if actual < self.options.min_segment_size:
            if self.segmentation[pos] == 0:
                self.segmentation[pos] = -1
            self.log_info("lane %d: failed, too small: %d", li, actual)
            self.counters["invalid-small-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        self.counters["voxels-segmented"].IncrementBy(actual)
        self.counters["voxels-overlapping"].IncrementBy(
            raw_segmented_voxels - actual)

        sid = self.get_next_segment_id()
        self.segmentation[sel][mask] = sid
        if self.keep_probability_maps:
            self.seg_prob[sel][mask] = storage.quantize_probability(
                expit(region_view(region, sel_start, sel_end)[mask]))
        self.overlaps[sid] = np.array([overlapped_ids, counts])
        self.origins[sid] = storage.OriginInfo(pos, num_iters, t_seg)
        self._post_segment(sid, sel, mask)
        self.counters["valid-time-ms"].IncrementBy(t_seg * MSEC_IN_SEC)
        self.log_info("lane %d: created supervoxel:%d seed(zyx):%s size:%d "
                      "iters:%d", li, sid, pos, actual, num_iters)
