"""Cross-subvolume lane filling: one lane batch, many subvolumes.

Counterpart of ffn_tpu/parallel/multi_canvas.py. The fused driver keeps K
subvolumes loaded: the engine's image and blocked volumes become (K, Z, Y,
X) stacks, each lane binds to a slot (LaneState.sv), idle lanes refill
from any subvolume with seeds left, and a finished subvolume is saved and
its slot reloaded. Finalization runs on the device (K8, the default: claims
into a per-slot segmentation, reseeds from a FIFO of banked seeds, a small
log a round, one download at save) or on the host (`device_finalize=False`
or with probability maps: seed screening, K7's verdicts and masks).

Objects in different subvolumes are independent; within one, the behavior
is HopBatchCanvas's; finished npz files are skipped on a rerun. Loads
(read, normalize, pad, upload on a copy stream through pinned memory) and
saves run on thread pools beside the rounds; loads are consumed in task
order, and a reloaded slot's seed policy starts only after the saves in
flight have landed (seed handoff reads the neighbors' files), so the
output does not depend on IO timing. Deviations: `mesh=` is not ported;
a round runs to its end inside run_hops (hop_engine.py), so seed work
queued behind it runs after it; slots are served round-robin where the
JAX driver serves materialized ones first (_slot_order), so the output
does not depend on thread timing.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ffn_tpu_torch.inference import batch_canvas as batch_canvas_lib
from ffn_tpu_torch.inference import hop_canvas as hop_canvas_lib
from ffn_tpu_torch.inference import hop_engine as hop_engine_lib
from ffn_tpu_torch.inference import storage

_IDLE = batch_canvas_lib._IDLE
_RUNNING = batch_canvas_lib._RUNNING


class SlotCanvas(hop_canvas_lib.HopBatchCanvas):
    """Host-side bookkeeping of ONE subvolume inside the fused driver.

    Owns the subvolume's segmentation, origins, counters, deferred seeds and
    finalization, while the lane state and the image and blocked stacks
    live on the driver, shared by all slots. Lane indices are global.
    """

    def __init__(self, driver, slot_index: int, model_info, engine, image,
                 options, **kwargs):
        self.driver = driver
        self.slot_index = slot_index
        # Bypasses HopBatchCanvas.__init__: a slot allocates no lane state
        # or blocked volume of its own.
        batch_canvas_lib.BatchCanvas.__init__(
            self, model_info, engine, image, options, lanes=driver.lanes,
            **kwargs)
        self.hops = driver.hops
        self._lanes = driver._lanes   # the global lanes (shared)
        self.seed_iter = None
        self.seeds_exhausted = False
        self.screened_ready = []   # banked strong seeds (driver)
        self._policy_fut = None
        # lane -> its finalization mask, fetched for a round's finishers in
        # one batched call (engine.lane_mask_regions) by the driver's ingest.
        self.mask_region_cache = {}

    # HopBatchCanvas's methods (drain, spill, requeue, region downloads)
    # reach the shared lane state through this property.
    @property
    def _state(self):
        return self.driver._state

    @_state.setter
    def _state(self, value):
        self.driver._state = value

    def _put_image_dev(self):
        return None   # the driver uploads into the shared image stack

    def _grid_shape(self):
        return self.driver.slot_shape   # the dedup grid of the padded slot

    def _active_lane_boxes(self):
        boxes = [(lane.min_pos - self._pred_size // 2,
                  lane.max_pos + self._pred_size // 2)
                 for li, lane in enumerate(self._lanes)
                 if self.driver.lane_slot[li] == self.slot_index
                 and lane.state == _RUNNING]
        if not boxes:
            return np.zeros((0, 2, 3), np.int64)
        return np.array(boxes)

    def _lane_mask_region(self, li, sel_start, size_zyx, start_pos):
        cached = self.mask_region_cache.pop(li, None)
        if cached is not None:
            return cached
        return super()._lane_mask_region(li, sel_start, size_zyx, start_pos)

    def _post_segment(self, sid, sel, mask):
        self.driver._blocked_dev = self.engine.update_blocked_region(
            self.driver._blocked_dev, [s.start for s in sel],
            mask.astype(np.uint8), slot=self.slot_index)

    def _refresh_blocked(self):
        self.driver.refresh_slot_blocked(self.slot_index)

    def log_info(self, s, *args):
        logging.info("[slot %d] " + s, self.slot_index, *args)


class MultiSubvolumeHopDriver:
    """Drives K concurrent subvolumes through one shared lane batch.

    tasks: (corner_zyx, size_zyx) subvolumes. The driver processes them
    all, keeping at most `slots` loaded at once, and saves each finished
    subvolume through runner.save_segmentation.
    """

    def __init__(self, runner, tasks: Sequence, lanes: int = 64,
                 slots: int = 4, hops: int = 16,
                 keep_probability_maps: bool = False,
                 device_finalize: bool = True, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the lane-axis sharding over several devices is not "
                "ported; ffn_tpu_torch runs on one card (ROADMAP.md)")
        self.runner = runner
        self.engine = runner.engine
        if not isinstance(self.engine, hop_engine_lib.HopEngine):
            raise TypeError("MultiSubvolumeHopDriver needs a HopEngine")
        self.tasks = deque(
            (tuple(int(v) for v in c), tuple(int(v) for v in s))
            for c, s in tasks)
        self.lanes = int(lanes)
        self.hops = int(hops)
        self.K = max(1, min(int(slots), len(self.tasks)))
        self.keep_probability_maps = keep_probability_maps
        self.max_iters_per_segment = int(
            runner.canvas_defaults.get("max_iters_per_segment", 0))

        # The common padded slot shape: the elementwise max of task sizes.
        sizes = np.array([s for _, s in self.tasks], np.int64).reshape(-1, 3)
        self.slot_shape = tuple(int(v) for v in sizes.max(axis=0)) \
            if len(sizes) else (1, 1, 1)

        self._lanes = [batch_canvas_lib._Lane() for _ in range(self.lanes)]
        self.lane_slot = np.full(self.lanes, -1, np.int32)
        self._skip_base = np.zeros((self.lanes, 3), np.int64)
        engine = self.engine
        self._state = engine.init_lane_state(self.lanes, self.slot_shape)
        self._image_dev = engine.put_stack(
            [None] * self.K, self.slot_shape, np.float32)
        # Empty slots are fully claimed, so no lane could move there.
        self._blocked_dev = engine.put_stack(
            [None] * self.K, self.slot_shape, np.uint8,
            fill=hop_engine_lib.BLOCKED_CLAIMED)
        self.shapes = np.tile(np.array(self.slot_shape, np.int32),
                              (self.K, 1))
        # Device finalization skips the POM downloads, so it cannot keep
        # probability maps.
        self.device_finalize = bool(device_finalize) \
            and not keep_probability_maps
        self._fstate = None
        self._fifo_entries = []      # this round's FIFO (slot, pos) rows
        self._fifo_consumed_est = 0  # last round's kernel consumption
        if self.device_finalize:
            # A FIFO for a full round's reseeds: on object-sparse volumes
            # a seed lives 2-3 hops, so a 16-hop round can take several
            # seeds per lane (multi_canvas.py:188-196).
            self._fstate = engine.init_finalize_state(
                self.K, self.lanes, self.slot_shape,
                fifo_capacity=max(8 * self.lanes, 512))
        # Seed screening: off by default in device-finalize mode, where K8
        # kills a dud in a hop or two; on in host mode, where a dud holds a
        # lane for a whole round (multi_canvas.py:214-227).
        env_screen = os.environ.get("FFN_TPU_SCREEN")
        self.screen_enabled = env_screen != "0" if env_screen is not None \
            else not self.device_finalize
        # The seed-supply watermark, in lanes: adaptive on the kernel's own
        # FIFO consumption unless pinned (multi_canvas.py:228-242).
        env_wm = os.environ.get("FFN_TPU_SCREEN_WATERMARK")
        self._wm_default = float(env_wm) if env_wm is not None else (
            2.0 if self.screen_enabled else 3.0)
        self._wm_mult = self._wm_default
        self._wm_adaptive = env_wm is None
        self.slots: list = [None] * self.K
        self._slot_meta: list = [None] * self.K   # (corner, size, alignment)
        self._next_serve = 0   # round-robin cursor of seed allocation
        self._pending_screens = []   # screen batches in flight
        self._policy_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="seed-policy")
        # Slot IO off the round loop: saves write on the io pool; loads
        # (read, normalize, pad, upload) on ONE loader thread, as h5py
        # handles are not safe for concurrent reads.
        self._io_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="slot-save")
        self._load_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="slot-load")
        self._copy_stream = torch.cuda.Stream(engine.device) \
            if engine.device.type == "cuda" else None
        self._save_futs = []
        self._prefetch = {}   # corner -> Future(load_subvolume_inputs)
        self._prefetch_next()   # overlap the first loads with setup
        self.completed = 0
        self.stats = {"rounds": 0, "executed": 0, "lane_rounds": 0,
                      "running_lane_rounds": 0, "t_hops": 0.0,
                      "t_ingest": 0.0, "t_seed": 0.0, "t_load": 0.0,
                      "t_reseed": 0.0}
        if self.tasks:
            self.warmup()

    def warmup(self):
        """Builds the CUDA kernels before the first round. Nothing else: the
        JAX driver compiles each program for its shapes here
        (multi_canvas.py:271-377), but eager CUDA has nothing to compile per
        shape, and the kernels take their shapes as arguments."""
        t0 = time.time()
        if self.engine.device.type == "cuda":
            from ffn_tpu_torch import _build
            _build.lib()
        self.stats["t_warmup"] = time.time() - t0

    # -- slot loading / saving ------------------------------------------------

    def refresh_slot_blocked(self, k: int):
        self._blocked_dev = self.engine.update_stack_slot(
            self._blocked_dev, k, self.slots[k]._build_blocked(),
            fill=hop_engine_lib.BLOCKED_CLAIMED)

    def _prefetch_load(self, corner, size):
        """Loader-thread work for one pending subvolume: read and normalize
        it, pad it to the slot shape and start its upload, so the slot
        reload finds the image on the device."""
        inputs = self.runner.load_subvolume_inputs(corner, size)
        img = inputs["image"]
        padded = np.zeros(self.slot_shape, np.float32)
        padded[tuple(slice(0, s) for s in img.shape)] = img
        if self._copy_stream is None:
            inputs["image_dev"] = (torch.from_numpy(padded), None)
            return inputs
        pinned = torch.from_numpy(padded).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = pinned.to(self.engine.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        inputs["image_dev"] = (dev, ready)
        return inputs

    def _prefetch_next(self, depth: int = 2):
        """Submits the next pending tasks' loads to the loader thread."""
        out_dir = self.runner.request.segmentation_output_dir
        pending = sum(1 for f in self._prefetch.values() if not f.done())
        for corner, size in self.tasks:
            if pending >= depth:
                break
            if corner in self._prefetch or os.path.exists(
                    storage.segmentation_path(out_dir, corner)):
                continue
            self._prefetch[corner] = self._load_pool.submit(
                self._prefetch_load, corner, size)
            pending += 1

    def _load_next_into(self, k: int) -> bool:
        """Loads the next pending subvolume into slot k; False if none is
        left. Loads are consumed in task order, so the task -> slot binding
        does not depend on IO timing."""
        request = self.runner.request
        while self.tasks:
            corner, size = self.tasks.popleft()
            if os.path.exists(storage.segmentation_path(
                    request.segmentation_output_dir, corner)):
                continue
            fut = self._prefetch.pop(corner, None)
            if fut is None:
                fut = self._load_pool.submit(self._prefetch_load, corner,
                                             size)
            inputs = fut.result()
            self._prefetch_next()
            slot = SlotCanvas(
                self, k, self.runner._model_info, self.engine,
                inputs["image"], request.inference_options,
                restrictor=inputs.get("restrictor"),
                counters=inputs["counters"],
                corner_zyx=inputs["dst_corner"],
                keep_probability_maps=self.keep_probability_maps,
                max_iters_per_segment=self.max_iters_per_segment)
            self.slots[k] = slot
            self._slot_meta[k] = (corner, size, inputs["alignment"])
            self.shapes[k] = np.array(slot.shape, np.int32)
            image_dev, ready = inputs["image_dev"]
            if ready is not None:
                stream = torch.cuda.current_stream(self.engine.device)
                stream.wait_event(ready)
                image_dev.record_stream(stream)
            self._image_dev = self.engine.update_stack_slot(
                self._image_dev, k, image_dev)
            self.refresh_slot_blocked(k)
            if self.device_finalize:
                # Device ids continue above any preloaded ids.
                self._fstate = self.engine.reset_slot_seg(
                    self._fstate, k, next_sid=slot._max_id + 1)
            # A seed handoff policy reads the finished neighbors' origins
            # from disk: join the saves in flight first, or its seeds would
            # depend on how far the io pool got.
            self._harvest_saves(wait=True)
            policy = self.runner.get_seed_policy(corner, size)
            slot.seed_policy = policy(slot)
            slot.seed_iter = iter(slot.seed_policy)
            slot.seeds_exhausted = False
            # The policy's coordinates (sobel, EDT, peaks) materialize off
            # the round loop; the first draw joins them.
            slot._policy_fut = self._policy_pool.submit(
                slot.seed_policy._materialize)
            logging.info("slot %d <- subvolume %r size %r (%d pending)",
                         k, corner, size, len(self.tasks))
            return True
        return False

    def _slot_finished(self, k: int) -> bool:
        slot = self.slots[k]
        if slot is None:
            return False
        if not slot.seeds_exhausted or slot._deferred:
            return False
        if slot.screened_ready:
            return False   # banked strong seeds still to flood
        if any(ref is slot for cands, *_ in self._pending_screens
               for _, ref, _ in cands):
            return False   # screen verdicts still in flight
        return not any(lane.state == _RUNNING
                       for li, lane in enumerate(self._lanes)
                       if self.lane_slot[li] == k)

    def _save_slot(self, k: int):
        """Detaches slot k and saves it off the round loop: the slot's
        device segmentation is copied (the slot is reset for its successor
        right after) and its copy to pinned host memory started here; the
        merge and the npz write run on the io pool."""
        slot = self.slots[k]
        corner, _, alignment = self._slot_meta[k]
        seg_host = None
        if self.device_finalize:
            # One transfer per subvolume replaces the host path's
            # per-object region downloads. Host -1 markers (weak and
            # too-small seeds) stay where the kernel claimed nothing.
            seg_host = hop_engine_lib.HostCopy(
                self.engine.slice_slot_seg(self._fstate, k, slot.shape))
        out_dir = self.runner.request.segmentation_output_dir
        seg_path = storage.segmentation_path(out_dir, corner)
        prob_path = storage.object_prob_path(out_dir, corner)

        def finish():
            if seg_host is not None:
                seg = seg_host.numpy()[0]
                claimed = seg > 0
                slot.segmentation[claimed] = seg[claimed]
            self.runner.save_segmentation(slot, alignment, seg_path,
                                          prob_path)
            logging.info("slot %d: subvolume %r saved (%d objects)", k,
                         corner, len(slot.origins))

        self._save_futs.append(self._io_pool.submit(finish))
        self.slots[k] = None
        self._slot_meta[k] = None
        self.completed += 1

    def _harvest_saves(self, wait: bool = False):
        """Raises an io-pool exception, if any; with wait=True joins every
        save (run() returns only when its outputs are on disk)."""
        pending = []
        for fut in self._save_futs:
            if wait or fut.done():
                fut.result()
            else:
                pending.append(fut)
        self._save_futs = pending

    # -- seed scheduling ------------------------------------------------------

    def _slot_order(self, active):
        """Active slots round-robin from the one after the last served.
        The JAX driver puts slots whose seed policy has materialized first
        (multi_canvas.py:555-568), which makes its seed schedule, and so
        its output, depend on thread timing; the port keeps the plain order,
        the JAX driver's whenever every policy is ready."""
        return [k for k in list(range(self._next_serve, self.K))
                + list(range(self._next_serve)) if k in active]

    def _assign_seeds(self, idle, active):
        """Host mode: distributes idle lanes over the active slots' banked
        seeds, revalidated (claims may have landed since screening), round
        robin from the slot after the last one served."""
        assignments = []   # (lane_index, slot_index, pos)
        remaining = list(idle)
        for k in self._slot_order(active):
            slot = self.slots[k]
            ready = slot.screened_ready
            while remaining and ready:
                pos = ready.pop(0)
                if not slot._valid_seed_pos(tuple(pos)):
                    continue   # claimed since screening
                assignments.append((remaining.pop(0), k, pos))
                self._next_serve = (k + 1) % self.K
        return assignments

    def _collect_screens(self, drain: bool = False):
        """Banks the verdicts of screen batches two rounds old (or all, with
        `drain`): duds get the weak-seed outcome the lane path would
        record, survivors join their slot's banked seeds. A batch whose
        slot was reloaded since is dropped (multi_canvas.py:594-647)."""
        if not self._pending_screens:
            return
        t0 = time.time()
        ready, pending = [], []
        for entry in self._pending_screens:
            if drain or entry[2] < self.stats["rounds"] - 1:
                ready.append(entry)
            else:
                pending.append(entry)
        self._pending_screens = pending
        for cands, strong_host, _ in ready:
            strong = strong_host.numpy()
            for (k, slot_ref, pos), ok in zip(cands, strong):
                slot = self.slots[k]
                if slot is not slot_ref:
                    continue
                if not ok:
                    p = tuple(int(v) for v in pos)
                    if slot.segmentation[p] == 0:
                        slot.segmentation[p] = -1
                    slot.counters["seed_got_too_weak"].Increment()
                    slot.counters["screened-weak-seeds"].Increment()
                else:
                    slot.screened_ready.append(pos)
        dt = time.time() - t0
        self.stats["t_screen"] = self.stats.get("t_screen", 0.0) + dt
        self.stats["collect_calls"] = self.stats.get("collect_calls", 0) + 1
        self.stats["t_screen_max"] = max(self.stats.get("t_screen_max", 0.0),
                                         dt)

    def _dispatch_screens(self, active, relax_quota=0, force=False):
        """Draws fresh candidates up to the watermark of banked or in-flight
        seeds and queues their dud-screen batches without waiting (or, with
        screening off, banks them as they are). The relaxed pass, which
        floods deferred seeds near running lanes, is capped at
        `relax_quota`, the lanes that sat hollow this round; `force` lifts
        the cap and the small-batch deferral (multi_canvas.py:649-776).
        Returns the number of candidates drawn."""
        order = self._slot_order(active)
        if not order:
            return 0
        banked = sum(len(self.slots[k].screened_ready) for k in order)
        in_flight = sum(len(c) for c, *_ in self._pending_screens)
        # This round's FIFO entries are neither banked nor assigned yet:
        # estimate their return from last round's consumption.
        fifo_est = max(0, len(self._fifo_entries) - self._fifo_consumed_est)
        need = int(self.lanes * self._wm_mult) - banked - in_flight \
            - fifo_est
        if need <= 0:
            return 0
        # Small top-ups waste a padded screen batch: wait for demand.
        if (self.screen_enabled and not force
                and need < min(32, self.lanes)):
            return 0

        def join_policy(slot):
            if slot._policy_fut is not None:
                slot._policy_fut.result()
                slot._policy_fut = None

        dispatched = 0
        relax_left = need if force else min(relax_quota, need)
        while need > 0:
            demand = min(need, self.engine.SCREEN_BATCH)
            cands = []   # (slot_index, slot_ref, pos)
            # Strict deferral first, then the relaxed pass up to its quota,
            # each splitting its share across the slots.
            for relax in (False, True):
                if len(cands) >= demand or (relax and relax_left <= 0):
                    break
                cap = demand if not relax \
                    else min(demand, len(cands) + relax_left)
                share = max(1, (cap - len(cands)) // len(order))
                for k in order:
                    if len(cands) >= cap:
                        break
                    slot = self.slots[k]
                    join_policy(slot)
                    t_d = time.time()
                    before = len(cands)
                    seeds, slot.seeds_exhausted = slot._draw_seeds(
                        min(share, cap - len(cands)), slot.seed_iter,
                        slot.seeds_exhausted,
                        relax_threshold=0 if relax else None)
                    self.stats["t_draw"] = self.stats.get(
                        "t_draw", 0.0) + time.time() - t_d
                    cands.extend((k, slot, pos) for pos in seeds)
                    if relax:
                        relax_left -= len(cands) - before
            if not cands:
                break
            if not self.screen_enabled:
                # Banked unscreened: K8's DONE_WEAK finalize reaches the
                # screen's verdict in a hop or two.
                for k, slot, pos in cands:
                    slot.screened_ready.append(pos)
            else:
                positions = np.array([p for _, _, p in cands], np.int32)
                sv = np.array([k for k, _, _ in cands], np.int32)
                init_act = self.slots[order[0]].options.init_activation
                strong = self.engine.screen_seeds_async(
                    self._image_dev, positions, init_act, sv=sv)
                self._pending_screens.append(
                    (cands, hop_engine_lib.HostCopy(strong),
                     self.stats["rounds"]))
                self.stats["screen_calls"] = self.stats.get(
                    "screen_calls", 0) + 1
                self.stats["screen_cands"] = self.stats.get(
                    "screen_cands", 0) + len(cands)
            dispatched += len(cands)
            need -= len(cands)
        return dispatched

    # -- device-finalize round plumbing ---------------------------------------

    def _fin_opts(self):
        """run_hops' fin_opts (the slot options are in logit space)."""
        o = next(s for s in self.slots if s is not None).options
        return np.array([o.segment_threshold, o.min_segment_size,
                         o.init_activation], np.float32)

    def _prep_round_fifo(self, active):
        """Loads this round's FIFO from the banked seeds (revalidated here;
        K8 re-checks claims at pop) round robin across slots, and sets the
        hold flags of lanes with a host-held spill. Returns (entries
        loaded, idle lanes left unfilled)."""
        S = self._fstate.fifo_pos.shape[0]
        order = self._slot_order(active)
        pools = {}
        for k in order:
            pool = self.slots[k].screened_ready
            self.slots[k].screened_ready = []
            ok = self.slots[k]._valid_seed_batch(np.asarray(pool)) \
                if pool else []
            pools[k] = [pos for pos, o in zip(pool, ok) if o]
        entries = []
        cursors = {k: 0 for k in order}
        progressed = True
        while len(entries) < S and progressed:
            progressed = False
            for k in order:
                if cursors[k] < len(pools[k]):
                    entries.append((k, pools[k][cursors[k]]))
                    cursors[k] += 1
                    progressed = True
                if len(entries) >= S:
                    break
        for k in order:   # a full FIFO: the surplus stays banked
            self.slots[k].screened_ready.extend(pools[k][cursors[k]:])
        if entries:
            self._next_serve = (entries[-1][0] + 1) % self.K
        pos = np.array([p for _, p in entries], np.int32).reshape(-1, 3)
        sv = np.array([k for k, _ in entries], np.int32)
        hold = np.array([bool(lane.spill) for lane in self._lanes], bool)
        self._fstate = self.engine.round_prep(self._fstate, pos, sv, hold)
        self._fifo_entries = entries
        idle = sum(1 for lane in self._lanes if lane.state == _IDLE)
        return len(entries), max(0, idle - len(entries))

    def _rebank_fifo(self, fifo_head: int):
        """Returns unconsumed FIFO entries to the front of their slots'
        banks and records the round's consumption for the watermark."""
        self._fifo_consumed_est = fifo_head
        leftover = self._fifo_entries[fifo_head:]
        self._fifo_entries = []
        by_slot = {}
        for k, pos in leftover:
            by_slot.setdefault(k, []).append(pos)
        for k, back in by_slot.items():
            if self.slots[k] is not None:
                self.slots[k].screened_ready = back + \
                    self.slots[k].screened_ready

    def _ingest_device(self, aux, rows):
        """Device-finalize ingest: applies the kernel's log to the slots'
        bookkeeping and refreshes the host lane mirrors from aux; the only
        per-lane device work left is the rare stall drain
        (multi_canvas.py:858-934)."""
        overflowed = int(aux["overflow"].sum())
        if overflowed:
            raise AssertionError(f"device queue dropped {overflowed} pushes "
                                 f"despite the stall gate")
        hop_canvas_lib.apply_finalize_rows(rows, self._lanes,
                                           lambda k: self.slots[k])
        skips = np.stack([aux["skip_threshold"], aux["skip_invalid"],
                          aux["skip_restricted"]], axis=1)
        delta = skips - self._skip_base
        self._skip_base = skips
        status_host = None
        for li, lane in enumerate(self._lanes):
            st = int(aux["status"][li])
            sv = int(aux["sv"][li])
            # A lane's round totals go to its end-of-round slot (the JAX
            # driver's documented approximation when a lane served two
            # slots in one round).
            slot = self.slots[sv] if 0 <= sv < self.K else None
            if slot is not None and st != hop_engine_lib.IDLE:
                slot.counters["fov-moves"].IncrementBy(
                    int(aux["executed"][li]))
                slot.counters["skip_threshold"].IncrementBy(
                    int(delta[li, 0]))
                slot.counters["skip_invalid_pos"].IncrementBy(
                    int(delta[li, 1]))
                slot.counters["skip_restriced_pos"].IncrementBy(
                    int(delta[li, 2]))
            # The lane's object comes from aux: K8 reseeds in the round.
            lane.start_pos = np.asarray(aux["start"][li])
            lane.min_pos = np.asarray(aux["minp"][li])
            lane.max_pos = np.asarray(aux["maxp"][li])
            lane.num_iters = int(aux["iters"][li])
            if st == hop_engine_lib.RUNNING:
                lane.state = _RUNNING
                self.lane_slot[li] = sv
            elif st == hop_engine_lib.STALLED_FULL:
                lane.state = _RUNNING
                self.lane_slot[li] = sv
                if status_host is None:
                    status_host = self._state.status.cpu().numpy().copy()
                slot._drain_lane_queue(li, lane)
                status_host[li] = hop_engine_lib.RUNNING
            elif st == hop_engine_lib.DONE_EMPTY:
                # Only under hold (a host-held spill): K8 finalizes every
                # other finished lane in the round.
                self.lane_slot[li] = sv
                lane.state = _RUNNING
                if lane.spill and slot._requeue_spill(li, lane):
                    if status_host is None:
                        status_host = self._state.status.cpu().numpy().copy()
                    status_host[li] = hop_engine_lib.RUNNING
                # Else the spill was all stale: hold clears next round and
                # K8 finalizes the lane at the next hop's entry.
            else:   # IDLE / DONE_FINALIZED: waits for FIFO seeds
                lane.state = _IDLE
        if status_host is not None:
            self._state.status.copy_(torch.as_tensor(status_host))

    # -- main loop ------------------------------------------------------------

    def run(self):
        """Processes every task; returns the number of saved subvolumes."""
        engine = self.engine
        B = self.lanes
        init_activation = None

        while True:
            # 1. Save finished subvolumes, reload their slots.
            t0 = time.time()
            self._harvest_saves()
            for k in range(self.K):
                if self._slot_finished(k):
                    self._save_slot(k)
            self.stats["t_save_disp"] = self.stats.get(
                "t_save_disp", 0.0) + time.time() - t0
            for k in range(self.K):
                if self.slots[k] is None:
                    self._load_next_into(k)
            self.stats["t_load"] += time.time() - t0
            active = [k for k in range(self.K) if self.slots[k] is not None]
            if not active:
                break
            if init_activation is None:
                init_activation = \
                    self.slots[active[0]].options.init_activation

            # 2. Bank landed screen verdicts, then refill idle lanes: the
            # FIFO for K8 (device finalization), or host seed assignment.
            t0 = time.time()
            self._collect_screens()
            t_collect = time.time() - t0
            n_fifo = 0
            assignments = []
            t0 = time.time()
            if self.device_finalize:
                n_fifo, unfilled = self._prep_round_fifo(active)
                self.stats["t_seed"] += time.time() - t0
            else:
                idle = [li for li, lane in enumerate(self._lanes)
                        if lane.state == _IDLE]
                assignments = self._assign_seeds(idle, active)
                # Lanes still hollow after the refill license next round's
                # relaxed draw, and no more.
                unfilled = len(idle) - len(assignments)
                self.stats["t_seed"] += time.time() - t0
                if assignments:
                    t0 = time.time()
                    reset_mask = np.zeros(B, bool)
                    reset_pos = np.zeros((B, 3), np.int32)
                    new_sv = np.array(self.lane_slot)
                    for li, k, pos in assignments:
                        self.slots[k]._start_lane(li, pos)
                        reset_mask[li] = True
                        reset_pos[li] = pos
                        new_sv[li] = k
                        self.lane_slot[li] = k
                        self._skip_base[li] = 0
                    self._state = engine.reseed_lanes(
                        self._state, reset_mask, reset_pos,
                        init_activation, sv=np.maximum(new_sv, 0))
                    self.stats["t_reseed"] += time.time() - t0

            running = [li for li, lane in enumerate(self._lanes)
                       if lane.state == _RUNNING]
            if not running and n_fifo == 0:
                # No supply: a blocking draw and screen (no round to hide
                # behind); the verdicts are banked right away.
                t0 = time.time()
                dispatched = self._dispatch_screens(active, force=True)
                self._collect_screens(drain=True)
                self.stats["t_seed"] += time.time() - t0
                self.stats["force_dispatches"] = self.stats.get(
                    "force_dispatches", 0) + 1
                logging.debug("starved: collect %.2fs assigned %d "
                              "force-dispatched %d", t_collect,
                              len(assignments), dispatched)
                if dispatched:
                    continue
                # No seeds anywhere: every active slot is finished (back to
                # save and reload), or this was the last of them.
                if all(self.slots[k] is None or self._slot_finished(k)
                       for k in range(self.K)) and not self.tasks:
                    for k in range(self.K):
                        if self.slots[k] is not None:
                            self._save_slot(k)
                    break
                continue

            # 3. One fused round across all subvolumes; its result's copy
            # starts at once, then the next refill's draws and screens.
            hops = self.hops
            t0 = time.time()
            if self.device_finalize:
                self._state, self._fstate, packed = engine.run_hops(
                    self._image_dev, self._blocked_dev, self._state, hops,
                    self.max_iters_per_segment, shapes=self.shapes,
                    sync=False, fstate=self._fstate,
                    fin_opts=self._fin_opts())
            else:
                self._state, packed = engine.run_hops(
                    self._image_dev, self._blocked_dev, self._state, hops,
                    self.max_iters_per_segment, shapes=self.shapes,
                    sync=False)
            packed = hop_engine_lib.HostCopy(packed)
            t1 = time.time()
            self._dispatch_screens(active, relax_quota=unfilled)
            t2 = time.time()
            if self.device_finalize:
                aux, fin_rows, fifo_head, fin_claimed = \
                    engine.unpack_round(packed, B, self.K)
            else:
                aux = engine.unpack_aux(packed)
            dt = time.time() - t0
            self.stats["t_hops"] += dt - (t2 - t1)
            self.stats["t_seed"] += t2 - t1
            self.stats.setdefault("round_times", []).append((hops, dt))
            self.stats["rounds"] += 1
            self.stats["executed"] += int(aux["executed"].sum())
            self.stats["pops"] = self.stats.get("pops", 0) + int(
                aux["pops"].sum())
            self.stats["max_lane_pops"] = max(
                self.stats.get("max_lane_pops", 0), int(aux["pops"].max()))
            self.stats["lane_rounds"] += B
            # With K8's mid-round reseeds, lanes seeded from this round's
            # FIFO count toward occupancy (an upper bound).
            self.stats["running_lane_rounds"] += (
                min(B, len(running) + n_fifo) if self.device_finalize
                else len(running))

            # 4. Ingest, routing each lane to its slot.
            t0 = time.time()
            if self.device_finalize:
                for k, c in enumerate(fin_claimed):
                    if c and self.slots[k] is not None:
                        self.slots[k].counters[
                            "skip_invalid_pos"].IncrementBy(int(c))
                loaded = len(self._fifo_entries)
                self.stats["fifo_loaded"] = self.stats.get(
                    "fifo_loaded", 0) + loaded
                self.stats["fifo_consumed"] = self.stats.get(
                    "fifo_consumed", 0) + fifo_head
                if self._wm_adaptive and loaded > 0:
                    # The kernel's own consumption is the supply signal
                    # (deterministic: it comes out of the round's array). A
                    # drained FIFO signals starvation only when it was
                    # sized like the batch.
                    if fifo_head >= loaded and loaded >= self.lanes:
                        self._wm_mult = min(self._wm_mult * 1.5, 8.0)
                    elif fifo_head < loaded // 2:
                        self._wm_mult = max(self._wm_mult * 0.9,
                                            self._wm_default)
                    self.stats["wm_mult"] = round(self._wm_mult, 3)
                self._rebank_fifo(fifo_head)
                self._ingest_device(aux, fin_rows)
            else:
                self._ingest(aux)
            t_ing = time.time() - t0
            self.stats["t_ingest"] += t_ing
            logging.debug(
                "round %d: collect %.2f assign %d fifo_in %d hops %.2f "
                "screen_disp %.2f ingest %.2f pops %d executed %d",
                self.stats["rounds"], t_collect, len(assignments), n_fifo,
                dt - (t2 - t1), t2 - t1, t_ing, int(aux["pops"].sum()),
                int(aux["executed"].sum()))

        self._harvest_saves(wait=True)
        return self.completed

    def _ingest(self, aux):
        """Host-finalize ingest (multi_canvas.py:1156-1283): counters, stall
        drains, spill requeues and finalization, with K7's verdicts as a
        pre-gate and one batched mask download for the round's
        candidates."""
        overflowed = int(aux["overflow"].sum())
        if overflowed:
            raise AssertionError(f"device queue dropped {overflowed} pushes "
                                 f"despite the stall gate")
        skips = np.stack([aux["skip_threshold"], aux["skip_invalid"],
                          aux["skip_restricted"]], axis=1)
        delta = skips - self._skip_base
        self._skip_base = skips

        status_host = None
        v_counts = v_ok = None
        if np.any((aux["status"] == hop_engine_lib.DONE_EMPTY)
                  | (aux["status"] == hop_engine_lib.DONE_CAP)):
            any_slot = next(s for s in self.slots if s is not None)
            v_counts, v_ok = self.engine.lane_verdicts(
                self._state, self._blocked_dev,
                any_slot.options.segment_threshold,
                any_slot.options.move_threshold)
            # The round's finalization masks in one batched download, for
            # the lanes that will reach it below (finished, verdict
            # approved, seed not claimed yet). A lane claimed later in this
            # round's arbitration wastes its mask; _finalize decides.
            cand = []
            for li, lane in enumerate(self._lanes):
                status = int(aux["status"][li])
                if lane.state != _RUNNING or status not in (
                        hop_engine_lib.DONE_EMPTY, hop_engine_lib.DONE_CAP):
                    continue
                if status == hop_engine_lib.DONE_EMPTY and lane.spill:
                    continue   # likely requeued, stays running
                if int(aux["iters"][li]) <= 0 or not v_ok[li]:
                    continue
                slot = self.slots[self.lane_slot[li]]
                if v_counts[li] < slot.options.min_segment_size:
                    continue
                pos = tuple(int(v) for v in lane.start_pos)
                if slot.segmentation[pos] > 0:
                    continue   # a seed-claimed drop: no download
                pred_half = slot._pred_size // 2
                minp = np.minimum(lane.min_pos, aux["minp"][li])
                maxp = np.maximum(lane.max_pos, aux["maxp"][li])
                sel_start = np.maximum(minp - pred_half, 0)
                sel_end = np.minimum(maxp + pred_half + 1, slot.shape)
                cand.append((li, slot, sel_start, sel_end - sel_start, pos))
            if cand:
                regions = self.engine.lane_mask_regions(
                    self._state.seeds, [c[0] for c in cand],
                    [c[2] for c in cand], [c[3] for c in cand],
                    any_slot.options.segment_threshold,
                    [c[4] for c in cand])
                for (li, slot, *_), res in zip(cand, regions):
                    slot.mask_region_cache[li] = res
        for li, lane in enumerate(self._lanes):
            if lane.state != _RUNNING:
                continue
            slot = self.slots[self.lane_slot[li]]
            slot.counters["fov-moves"].IncrementBy(int(aux["executed"][li]))
            slot.counters["skip_threshold"].IncrementBy(int(delta[li, 0]))
            slot.counters["skip_invalid_pos"].IncrementBy(int(delta[li, 1]))
            slot.counters["skip_restriced_pos"].IncrementBy(
                int(delta[li, 2]))
            lane.min_pos = np.minimum(lane.min_pos, aux["minp"][li])
            lane.max_pos = np.maximum(lane.max_pos, aux["maxp"][li])
            lane.num_iters = int(aux["iters"][li])
            status = int(aux["status"][li])
            if status == hop_engine_lib.RUNNING:
                continue
            if status == hop_engine_lib.STALLED_FULL:
                if status_host is None:
                    status_host = self._state.status.cpu().numpy().copy()
                slot._drain_lane_queue(li, lane)
                status_host[li] = hop_engine_lib.RUNNING
                continue
            if status == hop_engine_lib.DONE_EMPTY and lane.spill:
                if slot._requeue_spill(li, lane):
                    if status_host is None:
                        status_host = self._state.status.cpu().numpy().copy()
                    status_host[li] = hop_engine_lib.RUNNING
                    continue
            weak = status == hop_engine_lib.DONE_WEAK
            too_small = False
            if weak:
                slot.counters["seed_got_too_weak"].Increment()
            elif v_counts is not None:
                if not v_ok[li]:
                    weak = True
                elif v_counts[li] < slot.options.min_segment_size:
                    too_small = True
            if status == hop_engine_lib.DONE_CAP:
                slot.counters["iter-cap-hit"].Increment()
            slot._finalize(li, lane, weak=weak, too_small=too_small)
        if status_host is not None:
            self._state.status.copy_(torch.as_tensor(status_host))
        # Masks whose lane never reached _finalize's download must not leak
        # into a later round, where the lane holds another object.
        for slot in self.slots:
            if slot is not None:
                slot.mask_region_cache.clear()
