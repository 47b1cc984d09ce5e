"""BatchCanvas with the device-resident movement policy (HopEngine).

Counterpart of ffn_tpu/inference/hop_canvas.py. Every lane's FIFO and
dedup grid live on the device (hop_engine.LaneState); the host talks to
it every `hops` moves. With host finalization (the default) it reseeds
idle lanes, runs `run_hops`, ingests a per-lane status array and
finalizes finished lanes, mirroring claims into a device `blocked` volume
so validity is checked at pop time. With device finalization
(`device_finalize=True` or FFN_TPU_DEVFIN=1) K8 finalizes and reseeds in
the round and the host applies its log (`apply_finalize_rows`); the
segmentation crosses to the host at the end and at checkpoints.

Per object the semantics are the serial Canvas's (lanes=1 matches it);
another lane's claim shows at the next round boundary. A lane whose FIFO
cannot take a move's pushes STALLS; the host drains its queue (spilling
the newest overflow to a host list that returns when the device FIFO
empties) and resumes it, so objects are never truncated. A round-based
BatchCanvas checkpoint restores here too.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ffn_tpu_torch.inference import batch_canvas as batch_canvas_lib
from ffn_tpu_torch.inference import hop_engine as hop_engine_lib
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.inference.counters import TimedIter, timer_counter

_IDLE = batch_canvas_lib._IDLE
_RUNNING = batch_canvas_lib._RUNNING


def apply_finalize_rows(rows, lanes, slot_for_row):
    """Applies one round's kernel finalization log to host bookkeeping
    (origins, counters, weak and too-small markers; hop_canvas.py:45-87).
    `slot_for_row(k)` resolves a row's subvolume slot, None for a slot
    saved since the round was queued.

    Any row for a lane also clears its host-held spill: the row means the
    kernel finalized the lane's object (a held lane can still die weak or
    capped), so the spilled queue entries belong to a dead object.
    """
    for row in rows:
        (k, sid, z, y, x, iters, nvox, status, outcome,
         li) = (int(v) for v in row)
        lanes[li].spill = []
        slot = slot_for_row(k)
        if slot is None:
            continue
        pos = (z, y, x)
        if status == hop_engine_lib.DONE_CAP:
            slot.counters["iter-cap-hit"].Increment()
        if outcome == hop_engine_lib.FIN_SEGMENTED:
            slot.origins[sid] = storage.OriginInfo(pos, iters, 0.0)
            slot.overlaps[sid] = np.zeros((2, 0), np.int64)
            slot._max_id = max(slot._max_id, sid)
            slot.counters["voxels-segmented"].IncrementBy(nvox)
            slot.log_info(
                "lane %d: created supervoxel:%d seed(zyx):%s "
                "size:%d iters:%d", li, sid, pos, nvox, iters)
        elif outcome == hop_engine_lib.FIN_WEAK:
            if slot.segmentation[pos] == 0:
                slot.segmentation[pos] = -1
            slot.counters["seed_got_too_weak"].Increment()
        elif outcome == hop_engine_lib.FIN_CLAIMED:
            slot.counters["seed-claimed-drops"].Increment()
        elif outcome == hop_engine_lib.FIN_TOO_SMALL:
            if slot.segmentation[pos] == 0:
                slot.segmentation[pos] = -1
            slot.counters["segments-too-small"].Increment()


class HopBatchCanvas(batch_canvas_lib.BatchCanvas):
    """Batched flood fill with on-device movement (see module docstring).

    Args (beyond BatchCanvas): hops -- FFN moves executed per device round
    trip; seed_screening -- reject dud seeds in conv batches before they
    take a lane; device_finalize -- finalize in kernel (None: the
    FFN_TPU_DEVFIN environment variable, off by default; never with
    probability maps or a single lane).
    """

    _allocate_seed_batch = False   # the seeds live in the lane state

    def __init__(self, model_info, engine, image, options, hops: int = 16,
                 seed_screening: bool = True, device_finalize=None,
                 **kwargs):
        if not isinstance(engine, hop_engine_lib.HopEngine):
            raise TypeError("HopBatchCanvas requires a HopEngine")
        kwargs.pop("candidates_per_step", None)
        super().__init__(model_info, engine, image, options, **kwargs)
        self.hops = int(hops)
        self.seed_screening = bool(seed_screening)
        if device_finalize is None:
            device_finalize = bool(int(os.environ.get("FFN_TPU_DEVFIN",
                                                      "0")))
        self.device_finalize = (bool(device_finalize)
                                and not self.keep_probability_maps
                                and self.lanes > 1)
        self._fstate = None
        self._state = engine.init_lane_state(self.lanes, self.shape)
        self._blocked_dev = engine.put_blocked(self._build_blocked())
        # Per-lane cumulative device counters at the last ingest (device
        # counters reset on reseed; host counters are monotonic).
        self._skip_base = np.zeros((self.lanes, 3), np.int64)
        # Recent per-round live-lane counts (drives tail compaction);
        # compaction waits for a full window of low occupancy.
        self._alive_history = []
        self._compact_window = 8
        self._screened_ready = []

    # -- BatchCanvas hooks ----------------------------------------------------

    def _build_blocked(self) -> np.ndarray:
        """uint8 bit-code volume: BLOCKED_CLAIMED for segmented voxels,
        BLOCKED_RESTRICTED where the movement restrictor forbids moves.
        Separate bits keep skip-counter attribution exact on the device."""
        blocked = np.zeros(self.shape, np.uint8)
        dense = self.restrictor.dense_invalid_mask(self.shape)
        if dense is not None:
            blocked |= np.where(dense, hop_engine_lib.BLOCKED_RESTRICTED,
                                0).astype(np.uint8)
        if np.any(self.segmentation > 0):
            blocked |= np.where(self.segmentation > 0,
                                hop_engine_lib.BLOCKED_CLAIMED,
                                0).astype(np.uint8)
        return blocked

    def _lane_region(self, li, sel_start, size_zyx):
        return self.engine.lane_seed_region(self._state.seeds, li,
                                            sel_start, size_zyx)

    def _refresh_blocked(self):
        """Rebuilds the device blocked volume from the restrictor and the
        host segmentation."""
        self._blocked_dev = self.engine.put_blocked(self._build_blocked())

    def _lane_mask_region(self, li, sel_start, size_zyx, start_pos):
        return self.engine.lane_mask_region(
            self._state.seeds, li, sel_start, size_zyx,
            self.options.segment_threshold, start_pos)

    def _post_segment(self, sid, sel, mask):
        start = [s.start for s in sel]
        self._blocked_dev = self.engine.update_blocked_region(
            self._blocked_dev, start, mask.astype(np.uint8))

    # -- seed pre-screening ---------------------------------------------------

    def _assign_fresh_seeds(self, seed_iter, seeds_exhausted):
        """BatchCanvas._assign_fresh_seeds plus device pre-screening:
        candidates whose FIRST FFN update leaves the origin below the move
        threshold (the DONE_WEAK outcome) are rejected in one conv batch
        instead of occupying a lane for a round. Dud outcomes match the
        lane path (origin poisoned, weak counter); surplus strong seeds are
        cached and revalidated before use."""
        if not self.seed_screening:
            return super()._assign_fresh_seeds(seed_iter, seeds_exhausted)
        idle = [li for li, lane in enumerate(self._lanes)
                if lane.state == _IDLE]
        assignments = []
        ready = self._screened_ready
        while idle and ready:
            pos = ready.pop(0)
            if not self._valid_seed_pos(tuple(pos)):
                continue
            assignments.append((idle.pop(0), pos))

        while idle:
            # Draw even when the policy is exhausted: deferred seeds are
            # retried inside _draw_seeds; the loop ends when a draw comes
            # back empty. lanes=1 keeps strict draw order (no batch-ahead),
            # as exact serial parity needs.
            demand = min(2 * len(idle) + 8, self.engine.SCREEN_BATCH) \
                if self.lanes > 1 else 1
            cands, seeds_exhausted = self._draw_seeds(
                demand, seed_iter, seeds_exhausted,
                relax_threshold=self.lanes // 2)
            if not cands:
                break
            strong = self.engine.screen_seeds(
                self._image_dev, np.array(cands, np.int32),
                self.options.init_activation)
            for pos, ok in zip(cands, strong):
                if not ok:
                    p = tuple(int(v) for v in pos)
                    if self.segmentation[p] == 0:
                        self.segmentation[p] = -1
                    self.counters["seed_got_too_weak"].Increment()
                    self.counters["screened-weak-seeds"].Increment()
                elif idle:
                    assignments.append((idle.pop(0), pos))
                else:
                    ready.append(pos)
        return assignments, seeds_exhausted

    # -- device-finalize path --------------------------------------------------

    def _merge_device_seg(self):
        """Folds the device claims into the host segmentation (claims only
        grow, so merging is idempotent)."""
        seg_dev = self.engine.download_slot_seg(self._fstate, 0, self.shape)
        claimed = seg_dev > 0
        self.segmentation[claimed] = seg_dev[claimed]

    def _refill_screen_pool(self, seed_iter, seeds_exhausted, want):
        """Draws and screens candidates until `want` strong seeds are banked
        in _screened_ready or the supply is exhausted (hop_canvas.py
        :252-287). The relaxed pass is not capped here, as in the JAX
        canvas: capping changes which deferred seed floods first."""
        ready = self._screened_ready
        while len(ready) < want:
            demand = min(2 * max(want - len(ready), 8),
                         self.engine.SCREEN_BATCH)
            cands, seeds_exhausted = self._draw_seeds(
                demand, seed_iter, seeds_exhausted,
                relax_threshold=self.lanes // 2)
            if not cands:
                break
            strong = self.engine.screen_seeds(
                self._image_dev, np.array(cands, np.int32),
                self.options.init_activation)
            for pos, ok in zip(cands, strong):
                if ok:
                    ready.append(pos)
                else:
                    p = tuple(int(v) for v in pos)
                    if self.segmentation[p] == 0:
                        self.segmentation[p] = -1
                    self.counters["seed_got_too_weak"].Increment()
                    self.counters["screened-weak-seeds"].Increment()
        return seeds_exhausted

    def _segment_all_device(self, seed_iter):
        """Device-finalize main loop (hop_canvas.py:289-406): claims,
        verdicts and lane reseeds run in K8; the host draws and screens
        seeds, loads the round's FIFO and applies the round's log."""
        engine = self.engine
        B = self.lanes
        S = max(2 * B, 256)
        self._fstate = engine.init_finalize_state(1, B, self.shape,
                                                  fifo_capacity=S)
        if self._max_id:
            self._fstate = engine.reset_slot_seg(
                self._fstate, 0, next_sid=self._max_id + 1)
        fin_opts = np.array([self.options.segment_threshold,
                             self.options.min_segment_size,
                             self.options.init_activation], np.float32)
        seeds_exhausted = False
        while True:
            self._maybe_save_checkpoint()
            seeds_exhausted = self._refill_screen_pool(
                seed_iter, seeds_exhausted, B)
            ready = self._screened_ready
            entries = []
            while ready and len(entries) < S:
                pos = ready.pop(0)
                if self._valid_seed_pos(tuple(pos)):
                    entries.append(tuple(int(v) for v in pos))
            hold = np.array([bool(lane.spill) for lane in self._lanes], bool)
            running = [li for li, lane in enumerate(self._lanes)
                       if lane.state == _RUNNING]
            if not running and not entries:
                # With no lane active, _draw_seeds faces no deferral
                # boxes, so an empty refill means the supply is done.
                if seeds_exhausted and not ready and not self._deferred:
                    break
                continue
            self._fstate = engine.round_prep(
                self._fstate, np.array(entries, np.int32).reshape(-1, 3),
                np.zeros(len(entries), np.int32), hold)
            with timer_counter(self.counters, "predict"):
                self._state, self._fstate, packed = engine.run_hops(
                    self._image_dev, self._blocked_dev, self._state,
                    self.hops, self.max_iters_per_segment,
                    fstate=self._fstate, fin_opts=fin_opts, sync=False)
            # One device->host copy per round: the log rides in the array.
            aux, rows, fifo_head, fifo_claimed = engine.unpack_round(
                packed, B, 1)
            if int(fifo_claimed[0]):
                # FIFO seeds the kernel skipped as claimed at pop: the host
                # path counts the same event in _valid_seed_pos.
                self.counters["skip_invalid_pos"].IncrementBy(
                    int(fifo_claimed[0]))
            # Unconsumed FIFO entries return to the front of the pool.
            self._screened_ready = (list(entries[fifo_head:])
                                    + self._screened_ready)
            self._count_round(aux)
            apply_finalize_rows(rows, self._lanes, lambda k: self)

            status_host = None
            for li, lane in enumerate(self._lanes):
                st = int(aux["status"][li])
                lane.start_pos = np.asarray(aux["start"][li])
                lane.min_pos = np.asarray(aux["minp"][li])
                lane.max_pos = np.asarray(aux["maxp"][li])
                lane.num_iters = int(aux["iters"][li])
                if st == hop_engine_lib.RUNNING:
                    lane.state = _RUNNING
                elif st == hop_engine_lib.STALLED_FULL:
                    lane.state = _RUNNING
                    if status_host is None:
                        status_host = self._state.status.cpu().numpy().copy()
                    self._drain_lane_queue(li, lane)
                    status_host[li] = hop_engine_lib.RUNNING
                elif st == hop_engine_lib.DONE_EMPTY:
                    # Only reachable under hold (a host-held spill).
                    if lane.spill and self._requeue_spill(li, lane):
                        lane.state = _RUNNING
                        if status_host is None:
                            status_host = \
                                self._state.status.cpu().numpy().copy()
                        status_host[li] = hop_engine_lib.RUNNING
                    else:
                        # The spill was all stale: hold clears next round
                        # and the kernel finalizes it at the next entry.
                        lane.state = _RUNNING
                else:
                    lane.state = _IDLE
            if status_host is not None:
                self._state.status.copy_(torch.as_tensor(status_host))
        self._merge_device_seg()

    # -- main loop -------------------------------------------------------------

    def segment_all(self, seed_policy=seed_lib.PolicyPeaks,
                    partial_segment_iters: int = 0):
        del partial_segment_iters   # lane progress is restored per lane
        self.seed_policy = seed_policy(self)
        if self._seed_policy_state is not None:
            self.seed_policy.set_state(self._seed_policy_state)
            self._seed_policy_state = None
        seed_iter = TimedIter(self.seed_policy, self.counters,
                              "seed-policy")
        seeds_exhausted = False
        if self.device_finalize:
            with timer_counter(self.counters, "segment_all"):
                self._segment_all_device(seed_iter)
            self.log_info("Segmentation done.")
            return

        with timer_counter(self.counters, "segment_all"):
            while True:
                self._maybe_save_checkpoint()
                B = self.lanes

                # 1. Reseed idle lanes.
                reset_mask = np.zeros(B, bool)
                reset_pos = np.zeros((B, 3), np.int32)
                assignments, seeds_exhausted = self._assign_fresh_seeds(
                    seed_iter, seeds_exhausted)
                for li, pos in assignments:
                    self._start_lane(li, pos)
                    reset_mask[li] = True
                    reset_pos[li] = pos
                    self._skip_base[li] = 0
                if reset_mask.any():
                    self._state = self.engine.reseed_lanes(
                        self._state, reset_mask, reset_pos,
                        self.options.init_activation)

                alive = [li for li, lane in enumerate(self._lanes)
                         if lane.state == _RUNNING]
                if not alive:
                    if seeds_exhausted:
                        break
                    continue

                # Tail compaction: once the seed supply is exhausted and
                # recent rounds used at most 1/4 of the lanes, shrink the
                # batch so the remaining objects stop paying for dead
                # lanes' conv slots (peak over a window, so a transient dip
                # does not over-shrink).
                self._alive_history.append(len(alive))
                if len(self._alive_history) > self._compact_window:
                    self._alive_history.pop(0)
                peak = max(self._alive_history)
                if (seeds_exhausted and self.lanes > 8
                        and len(self._alive_history) == self._compact_window
                        and peak <= self.lanes // 4):
                    new_b = max(8, 2 * peak)
                    self.log_info(
                        "Compacting %d lanes -> %d (%d alive, seeds "
                        "exhausted).", self.lanes, new_b, len(alive))
                    keep = alive + [alive[0]] * (new_b - len(alive))
                    compacted = self.engine.compact_lanes(self._state, keep)
                    if compacted is None:
                        # Input + compacted copy do not fit in device
                        # memory: keep running full-width and do not retry
                        # until occupancy drops further.
                        self.log_info("Compaction to %d lanes skipped "
                                      "(device memory).", new_b)
                        self._alive_history = []
                        continue
                    self._state = compacted
                    # Padding lanes duplicate a live lane's buffers but
                    # start IDLE with nothing to do.
                    self._state.status[len(alive):] = hop_engine_lib.IDLE
                    self._lanes = [self._lanes[li] for li in alive] + [
                        batch_canvas_lib._Lane()
                        for _ in range(new_b - len(alive))]
                    self.lanes = new_b
                    self._skip_base = self._skip_base[keep]
                    self._skip_base[len(alive):] = 0
                    self._alive_history = []
                    continue

                # 2. One multi-hop device round for all lanes. Fresh lanes
                # have unknown lifetimes (a weak seed dies on hop 1), so
                # rounds that just reseeded many lanes run short.
                many_fresh = len(assignments) > max(1, B // 4)
                hops = max(1, self.hops // 4) if many_fresh else self.hops
                with timer_counter(self.counters, "predict"):
                    self._state, aux = self.engine.run_hops(
                        self._image_dev, self._blocked_dev, self._state,
                        hops, self.max_iters_per_segment)
                self._ingest(aux)

        self.log_info("Segmentation done.")

    def _count_round(self, aux):
        """A round's moves, skips (device counters are per lane since its
        reseed; host counters are monotonic) and the overflow check."""
        self.counters["fov-moves"].IncrementBy(int(aux["executed"].sum()))
        skips = np.stack([aux["skip_threshold"], aux["skip_invalid"],
                          aux["skip_restricted"]], axis=1)
        delta = skips - self._skip_base
        self._skip_base = skips
        self.counters["skip_threshold"].IncrementBy(int(delta[:, 0].sum()))
        self.counters["skip_invalid_pos"].IncrementBy(int(delta[:, 1].sum()))
        self.counters["skip_restriced_pos"].IncrementBy(
            int(delta[:, 2].sum()))
        overflowed = int(aux["overflow"].sum())
        if overflowed:
            # The stall-before-full gate makes device-side drops
            # impossible; a nonzero counter means an engine bug.
            raise AssertionError(f"device queue dropped {overflowed} "
                                 f"pushes despite the stall gate")

    def _ingest(self, aux):
        """3. Ingests a round's per-lane results: counters, stall drains,
        spill requeues, and finalization of finished lanes."""
        self._count_round(aux)

        status_host = None
        # One batched device call (K7) answers weak/too-small for every
        # finalizing lane, skipping their region downloads.
        v_counts = v_ok = None
        if np.any((aux["status"] == hop_engine_lib.DONE_EMPTY)
                  | (aux["status"] == hop_engine_lib.DONE_CAP)):
            v_counts, v_ok = self.engine.lane_verdicts(
                self._state, self._blocked_dev,
                self.options.segment_threshold, self.options.move_threshold)
        for li, lane in enumerate(self._lanes):
            if lane.state != _RUNNING:
                continue
            lane.min_pos = np.minimum(lane.min_pos, aux["minp"][li])
            lane.max_pos = np.maximum(lane.max_pos, aux["maxp"][li])
            lane.num_iters = int(aux["iters"][li])
            status = int(aux["status"][li])
            if status == hop_engine_lib.RUNNING:
                continue
            if status == hop_engine_lib.STALLED_FULL:
                if status_host is None:
                    status_host = self._state.status.cpu().numpy().copy()
                self._drain_lane_queue(li, lane)
                status_host[li] = hop_engine_lib.RUNNING
                continue
            if status == hop_engine_lib.DONE_EMPTY and lane.spill:
                if self._requeue_spill(li, lane):
                    if status_host is None:
                        status_host = self._state.status.cpu().numpy().copy()
                    status_host[li] = hop_engine_lib.RUNNING
                    continue
            weak = status == hop_engine_lib.DONE_WEAK
            too_small = False
            if weak:
                self.counters["seed_got_too_weak"].Increment()
            elif v_counts is not None:
                if not v_ok[li]:
                    weak = True
                elif v_counts[li] < self.options.min_segment_size:
                    too_small = True
            if status == hop_engine_lib.DONE_CAP:
                self.counters["iter-cap-hit"].Increment()
            self._finalize(li, lane, weak=weak, too_small=too_small)
        if status_host is not None:
            self._state.status.copy_(torch.as_tensor(status_host))

    # -- queue overflow handling ----------------------------------------------

    def _grid_shape(self):
        """The shape the device dedup grid was sized for (the fused driver
        pads every slot to one shape)."""
        return self.shape

    def _screen_entries(self, lane, qpos, qscore, done_grid):
        """Drops queue entries that are already stale (visited cell, out of
        bounds, claimed, restricted), with the counter attribution the
        device pop would apply. Below-threshold entries stay (the seed
        values live on the device). Order is preserved."""
        _, grid_off = self.engine.grid_geometry(self._grid_shape())
        deltas = np.maximum(self._deltas_zyx, 1)
        keep_pos, keep_score = [], []
        for pos, score in zip(qpos, qscore):
            cell = tuple((pos - lane.start_pos + deltas // 2) // deltas
                         + grid_off)
            if done_grid[cell]:
                continue   # dedup: uncounted, like the reference
            p = tuple(int(v) for v in pos)
            if not self._pos_in_bounds(p) or self.segmentation[p] > 0:
                self.counters["skip_invalid_pos"].Increment()
                continue
            if not self.restrictor.is_valid_pos(p):
                self.counters["skip_restriced_pos"].Increment()
                continue
            keep_pos.append(pos)
            keep_score.append(score)
        return keep_pos, keep_score

    def _drain_lane_queue(self, li: int, lane):
        """Handles a STALLED_FULL lane: screens out stale entries, keeps
        the oldest entries on the device, spills the newest remainder to
        the host-side lane.spill list (FIFO order preserved)."""
        qpos, qscore = self.engine.download_lane_queue(self._state, li)
        done_grid = self.engine.download_lane_done(self._state, li)
        keep_pos, keep_score = self._screen_entries(lane, qpos, qscore,
                                                    done_grid)
        # Refill strictly below the stall threshold (Q - 6) so the lane
        # always executes at least one move before it can stall again.
        cap = max(1, self.engine.queue_capacity - 6)
        device_n = min(len(keep_pos), cap)
        for pos, score in zip(keep_pos[device_n:], keep_score[device_n:]):
            lane.spill.append((float(score), tuple(int(v) for v in pos)))
        self._state = self.engine.upload_lane_queue(
            self._state, li,
            np.array(keep_pos[:device_n], np.int32).reshape(-1, 3),
            np.array(keep_score[:device_n], np.float32))
        self.counters["queue-stall-drains"].Increment()
        self.log_info(
            "lane %d: queue stall drained (%d entries -> %d on device, "
            "%d spilled)", li, len(qpos), device_n, len(lane.spill))

    def _requeue_spill(self, li: int, lane) -> bool:
        """Moves spilled entries back onto the (now empty) device queue.
        Returns False when every spilled entry turned out stale (the lane
        is genuinely done)."""
        entries = lane.spill
        lane.spill = []
        qpos = np.array([p for _, p in entries], np.int64).reshape(-1, 3)
        qscore = np.array([s for s, _ in entries], np.float32)
        done_grid = self.engine.download_lane_done(self._state, li)
        keep_pos, keep_score = self._screen_entries(lane, qpos, qscore,
                                                    done_grid)
        if not keep_pos:
            return False
        cap = max(1, self.engine.queue_capacity - 6)
        device_n = min(len(keep_pos), cap)
        lane.spill = [(float(s), tuple(int(v) for v in p))
                      for p, s in zip(keep_pos[device_n:],
                                      keep_score[device_n:])]
        self._state = self.engine.upload_lane_queue(
            self._state, li,
            np.array(keep_pos[:device_n], np.int32).reshape(-1, 3),
            np.array(keep_score[:device_n], np.float32))
        return True

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, path: str):
        """Writes the hop-format checkpoint (hop_canvas.py:677-740): the
        shared state plus, per lane in flight, its POM region, device
        queue, spill, dedup grid and fresh flag. Device claims are folded
        into the host segmentation first; on restore they come back through
        the blocked volume, and new ids continue above them."""
        if self._fstate is not None:
            self._merge_device_seg()
        self.log_info("Saving hop-canvas checkpoint to %s.", path)
        with timer_counter(self.counters, "save_checkpoint"):
            lanes_state = []
            deferred = list(self._deferred)
            fresh = self._state.fresh.cpu().numpy()
            for li, lane in enumerate(self._lanes):
                if lane.state != _RUNNING or lane.num_iters <= 0:
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
                qpos, qscore = self.engine.download_lane_queue(self._state,
                                                               li)
                lanes_state.append({
                    "start_pos": np.asarray(lane.start_pos),
                    "qpos": qpos, "qscore": qscore,
                    "spill_pos": np.array([p for _, p in lane.spill],
                                          np.int64).reshape(-1, 3),
                    "spill_score": np.array(
                        [s for s, _ in lane.spill], np.float32),
                    "done_grid": self.engine.download_lane_done(
                        self._state, li),
                    "fresh": bool(fresh[li]),
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
                    hop_format=np.int64(1),
                    segmentation=self.segmentation,
                    origins=self.origins,
                    overlaps=self.overlaps,
                    deferred=np.array(deferred, np.int64).reshape(-1, 3),
                    lanes=np.asarray(lanes_state, dtype=object),
                    seed_policy_state=np.asarray(seed_policy_state,
                                                 dtype=object),
                    counters=self.counters.dumps_np(),
                    **aux)
        self.log_info("Hop-canvas checkpoint saved.")

    def restore_checkpoint(self, path: str) -> int:
        """Restores a hop-format or a round-based checkpoint
        (hop_canvas.py:742-842). Lanes beyond this canvas's lane count go
        back to the deferred pool and re-flood from their seeds."""
        self.log_info("Restoring hop-canvas checkpoint: %s", path)
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=True)
            legacy = "hop_format" not in data
            if legacy:
                self.log_info("Round-based BatchCanvas checkpoint; "
                              "converting its lanes to the hop format.")
            self.segmentation[...] = data["segmentation"]
            if self.keep_probability_maps and "seg_qprob" in data:
                self.seg_prob[...] = data["seg_qprob"]
            self.origins = storage._read_origins_entry(path)
            self.overlaps = data["overlaps"].item()
            self._deferred = batch_canvas_lib._SeedPool(data["deferred"])
            self._max_id = int(np.max(self.segmentation, initial=0))
            self._seed_policy_state = data["seed_policy_state"]
            self.counters.loads_np(data["counters"])
            self._refresh_blocked()

            state = self._state
            host = {name: getattr(state, name).cpu().numpy().copy()
                    for name in ("status", "fresh", "start", "minp", "maxp",
                                 "iters")}
            for li, saved in enumerate(data["lanes"]):
                if saved is None:
                    continue
                if li >= self.lanes:
                    # The in-flight flood fill cannot be adopted, but the
                    # object must not be lost: its seed re-floods.
                    self._deferred.append(tuple(
                        int(v) for v in saved["start_pos"]))
                    continue
                if legacy:
                    saved = self._convert_legacy_lane(saved)
                lane = self._lanes[li]
                lane.state = _RUNNING
                lane.start_pos = np.asarray(saved["start_pos"])
                lane.spill = [
                    (float(s), tuple(int(v) for v in p))
                    for p, s in zip(saved.get("spill_pos", ()),
                                    saved.get("spill_score", ()))]
                lane.min_pos = np.asarray(saved["min_pos"])
                lane.max_pos = np.asarray(saved["max_pos"])
                lane.num_iters = int(saved["num_iters"])
                lane.t_start = time.time()
                host["status"][li] = hop_engine_lib.RUNNING
                host["fresh"][li] = bool(saved["fresh"])
                host["start"][li] = saved["start_pos"]
                host["minp"][li] = saved["min_pos"]
                host["maxp"][li] = saved["max_pos"]
                host["iters"][li] = saved["num_iters"]
                state = self.engine.upload_lane_queue(
                    state, li, saved["qpos"], saved["qscore"])
                state = self.engine.upload_lane_done(state, li,
                                                     saved["done_grid"])
                self.engine.set_lane_seed_region(
                    state.seeds, li, saved["region_start"], saved["region"])
            for name, value in host.items():
                getattr(state, name).copy_(torch.as_tensor(value))
            self._state = state
            self._skip_base = np.stack(
                [state.skip_threshold.cpu().numpy(),
                 state.skip_invalid.cpu().numpy(),
                 state.skip_restricted.cpu().numpy()],
                axis=1).astype(np.int64)
        self.log_info("Hop-canvas checkpoint restored (%d lanes in "
                      "flight).", sum(1 for lane in self._lanes
                                      if lane.state == _RUNNING))
        return 0

    def _convert_legacy_lane(self, saved: dict) -> dict:
        """A round-based lane (host FIFO of (score, pos) after its pending
        candidates, done-cell list) in the hop format (hop_canvas.py
        :825-842)."""
        entries = list(saved["pending"]) + list(saved["queue"])
        qpos = np.array([p for _, p in entries], np.int32).reshape(-1, 3)
        qscore = np.array([s for s, _ in entries], np.float32)
        grid, offset = self.engine.grid_geometry(self.shape)
        done_grid = np.zeros(grid, np.uint8)
        cells = np.asarray(saved["done_cells"], np.int64).reshape(-1, 3)
        if len(cells):
            idx = cells + np.array(offset)
            done_grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
        out = dict(saved)
        out.update(qpos=qpos, qscore=qscore, done_grid=done_grid,
                   fresh=int(out["num_iters"]) == 0)
        return out
