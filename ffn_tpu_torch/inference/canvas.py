"""Inference canvas: the serial Canvas of ffn_tpu/inference/canvas.py, its
host logic copied line for line (logit thresholds, NaN as unvisited, the
movement loop, weak-seed and min-size rejection, origins, checkpoints with
the same npz keys); it drives ffn_tpu_torch's engine and keeps an exact
host mirror of the device seed from the patches it writes.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch
from scipy.special import expit, logit

from ffn_tpu_torch.inference import movement
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.inference.counters import (Counters, TimedIter,
                                              timer_counter)

MSEC_IN_SEC = 1000


class Canvas:
    """Tracks the inference state and results within one subvolume."""

    def __init__(self, model_info, engine, image, options,
                 voxel_size_zyx=(1, 1, 1), counters=None, restrictor=None,
                 movement_policy_fn=None, keep_history=False,
                 checkpoint_path=None, checkpoint_interval_sec=0,
                 corner_zyx=None, keep_probability_maps=False):
        """Args:
          model_info: ModelInfo for the FFN model
          engine: FloodFillEngine bound to the model + params
          image: (z, y, x) ndarray, already normalized
          options: settings.InferenceOptions (probability space; converted
            to logits here)
          voxel_size_zyx: voxel size for anisotropic EDT in seed policies
          counters: optional Counters registry
          restrictor: optional MovementRestrictor
          movement_policy_fn: callable(canvas) -> movement policy
          keep_history: record FoV positions and deleted-voxel stats
          checkpoint_path: where to write canvas checkpoints
          checkpoint_interval_sec: <= 0 disables checkpointing
          corner_zyx: spatial corner of `image` within the containing volume
          keep_probability_maps: track the quantized POM for .prob output
        """
        self.engine = engine
        self.image = np.ascontiguousarray(image, dtype=np.float32)
        self.voxel_size_zyx = voxel_size_zyx

        # Probability -> logit space, once (inference.py:188-195); the
        # options round to float32 as the JAX package's proto fields do.
        self.options = dataclasses.replace(options, **{
            attr: float(logit(getattr(options, attr)))
            for attr in ("init_activation", "pad_value", "move_threshold",
                         "segment_threshold")})

        self.counters = counters if counters is not None else Counters()
        self.checkpoint_interval_sec = checkpoint_interval_sec
        self.checkpoint_path = checkpoint_path
        self.checkpoint_last = time.time()

        self._keep_history = keep_history
        self.corner_zyx = corner_zyx
        self.shape = self.image.shape

        self.restrictor = restrictor if restrictor is not None else \
            movement.MovementRestrictor()

        # ZYX geometry.
        self._pred_size = np.array(model_info.pred_mask_size[::-1])
        self._input_seed_size = np.array(model_info.input_seed_size[::-1])
        self._input_image_size = np.array(model_info.input_image_size[::-1])
        self.margin = self._input_image_size // 2
        self._pred_delta = (self._input_seed_size - self._pred_size) // 2
        assert np.all(self._pred_delta >= 0)

        # Host mirror of the POM logits (NaN = unvisited); the device buffer
        # in self._seed_dev holds the same values.
        self.seed = np.full(self.shape, np.nan, np.float32)
        self._image_dev = engine.put_image(self.image)
        self._seed_dev = engine.new_seed_buffer(self.shape)

        self.segmentation = np.zeros(self.shape, np.int32)
        self.keep_probability_maps = keep_probability_maps
        self.seg_prob = np.zeros(self.shape, np.uint8) \
            if keep_probability_maps else None

        self.global_to_local_ids = {}
        self.local_to_global_ids = {}

        self.seed_policy = None
        self._seed_policy_state = None
        self._max_id = 0
        self.origins = {}   # segment id -> OriginInfo
        self.overlaps = {}  # segment id -> (ids, counts)

        # Whether to reset the seed for each new segment.
        self.reset_seed_per_segment = True

        if movement_policy_fn is None:
            self.movement_policy = movement.FaceMaxMovementPolicy(
                self, deltas=model_info.deltas[::-1],
                score_threshold=self.options.move_threshold)
        else:
            self.movement_policy = movement_policy_fn(self)

        self._hosts = []
        self.reset_state((0, 0, 0))
        self.t_last_predict = None
        self.log_info("Constructed canvas with corner %s (zyx) and shape %s",
                      self.corner_zyx, self.shape)

    def log_info(self, string, *args, **kwargs):
        logging.info(string, *args, **kwargs)

    def local_id(self, segment_id: int):
        return self.global_to_local_ids.get(segment_id, segment_id)

    def reset_state(self, start_pos, reset_extents=True):
        """Prepares the canvas for segmenting a new object."""
        self.movement_policy.reset_state(start_pos)
        self.history = []
        self.history_deleted = []
        if reset_extents:
            self._min_pos = np.array(start_pos)
            self._max_pos = np.array(start_pos)

    def is_valid_pos(self, pos, ignore_move_threshold=False) -> bool:
        """Whether FFN inference should run at `pos` (z, y, x)."""
        if not ignore_move_threshold:
            if self.seed[pos] < self.options.move_threshold:
                self.counters["skip_threshold"].Increment()
                return False

        np_pos = np.array(pos)
        low = np_pos - self.margin
        high = np_pos + self.margin
        if np.any(low < 0) or np.any(high >= self.shape):
            self.counters["skip_invalid_pos"].Increment()
            return False

        if self.segmentation[pos] > 0:
            self.counters["skip_invalid_pos"].Increment()
            return False
        return True

    def init_seed(self, pos):
        """Resets the object mask to a single seed at `pos`."""
        self.seed[...] = np.nan
        self.seed[pos] = self.options.init_activation
        self._seed_dev = self.engine.reset_seed(
            self._seed_dev, pos, self.options.init_activation)

    def get_next_segment_id(self) -> int:
        self._max_id += 1
        while self._max_id in self.origins:
            self._max_id += 1
        return self._max_id

    def update_at(self, pos) -> np.ndarray:
        """One FFN update at `pos`; returns the new POM patch (logits)."""
        with timer_counter(self.counters, "update_at"):
            if self.t_last_predict is not None:
                dt = time.time() - self.t_last_predict
                self.counters["inference-not-predict-ms"].IncrementBy(
                    dt * MSEC_IN_SEC)
            with timer_counter(self.counters, "predict"):
                self._seed_dev, logits = self.engine.step(
                    self._image_dev, self._seed_dev, pos)
            self.t_last_predict = time.time()

            off = self._input_seed_size // 2
            start = np.array(pos) - off + self._pred_delta
            end = start + self._pred_size
            sel = tuple(slice(s, e) for s, e in zip(start, end))

            if self._keep_history and self.options.disco_seed_threshold >= 0:
                old_seed = self.seed[sel]
                with np.errstate(invalid="ignore"):
                    self.history_deleted.append(
                        int(np.sum((old_seed >= logit(0.8))
                                   & (logits < logit(0.5)))))

            # Mirror the device write-back.
            self.seed[sel] = logits
        return logits

    def segment_at(self, start_pos, partial_segment_iters=0) -> int:
        """Flood-fills one object from `start_pos`; returns #iterations."""
        if not partial_segment_iters:
            if self.reset_seed_per_segment:
                self.init_seed(start_pos)
            self.reset_state(start_pos,
                             reset_extents=self.reset_seed_per_segment)
            if not self.movement_policy:
                # Seed the queue; arbitrary score, consumed immediately.
                self.movement_policy.append(
                    (self.movement_policy.score_threshold * 2, start_pos))

        num_iters = partial_segment_iters

        with timer_counter(self.counters, "segment_at-loop"):
            for pos in self.movement_policy:
                if self.seed[start_pos] < self.options.move_threshold:
                    self.counters["seed_got_too_weak"].Increment()
                    break
                if not self.restrictor.is_valid_pos(pos):
                    self.counters["skip_restriced_pos"].Increment()
                    continue

                pred = self.update_at(pos)
                self._min_pos = np.minimum(self._min_pos, pos)
                self._max_pos = np.maximum(self._max_pos, pos)
                num_iters += 1

                with timer_counter(self.counters, "movement_policy"):
                    self.movement_policy.update(pred, pos)

                if self._keep_history:
                    self.history.append(pos)
                self._maybe_save_checkpoint(partial_segment_iters=num_iters)

        return num_iters

    def segment_all(self, seed_policy=seed_lib.PolicyPeaks,
                    partial_segment_iters=0):
        """Segments the whole subvolume from seed-policy starting points."""
        self.seed_policy = seed_policy(self)
        if self._seed_policy_state is not None:
            self.seed_policy.set_state(self._seed_policy_state)
            self._seed_policy_state = None

        with timer_counter(self.counters, "segment_all"):
            mbd = np.array(self.options.min_boundary_dist)  # zyx

            for pos in TimedIter(self.seed_policy, self.counters,
                                 "seed-policy"):
                if not (self.is_valid_pos(pos, ignore_move_threshold=True)
                        and self.restrictor.is_valid_pos(pos)
                        and self.restrictor.is_valid_seed(pos)):
                    continue

                if not partial_segment_iters:
                    self._maybe_save_checkpoint(partial_segment_iters=0)

                # Too close to an existing segment?
                low = np.array(pos) - mbd
                high = np.array(pos) + mbd + 1
                sel = tuple(slice(s, e) for s, e in zip(low, high))
                if np.any(self.segmentation[sel] > 0):
                    self.segmentation[pos] = -1
                    continue

                self.log_info("Starting segmentation at %r (zyx)", pos)
                seg_start = time.time()
                num_iters = self.segment_at(
                    pos, partial_segment_iters=partial_segment_iters)
                partial_segment_iters = 0
                t_seg = time.time() - seg_start

                if num_iters <= 0:
                    self.counters["invalid-other-time-ms"].IncrementBy(
                        t_seg * MSEC_IN_SEC)
                    continue

                # Weak seed?
                if self.seed[pos] < self.options.move_threshold:
                    if self.segmentation[pos] == 0:
                        self.segmentation[pos] = -1
                    self.log_info("Failed: weak seed")
                    self.counters["invalid-weak-time-ms"].IncrementBy(
                        t_seg * MSEC_IN_SEC)
                    continue

                self._finalize_segment(pos, num_iters, t_seg)
                self._maybe_save_checkpoint(partial_segment_iters=0)

        self.log_info("Segmentation done.")

    def _finalize_segment(self, pos, num_iters, t_seg):
        """Thresholds the POM into a segment, resolving overlaps."""
        # Restrict processing to the bbox actually visited.
        sel = tuple(
            slice(max(s, 0), e + 1)
            for s, e in zip(self._min_pos - self._pred_size // 2,
                            self._max_pos + self._pred_size // 2))

        with np.errstate(invalid="ignore"):
            mask = self.seed[sel] >= self.options.segment_threshold
        raw_segmented_voxels = int(np.sum(mask))

        # Record overlapped existing segments.
        overlapped_ids, counts = np.unique(self.segmentation[sel][mask],
                                           return_counts=True)
        valid = overlapped_ids > 0
        overlapped_ids = overlapped_ids[valid]
        counts = counts[valid]

        # New segments only where currently empty.
        mask &= self.segmentation[sel] <= 0
        actual_segmented_voxels = int(np.sum(mask))

        if actual_segmented_voxels < self.options.min_segment_size:
            if self.segmentation[pos] == 0:
                self.segmentation[pos] = -1
            self.log_info("Failed: too small: %d", actual_segmented_voxels)
            self.counters["invalid-small-time-ms"].IncrementBy(
                t_seg * MSEC_IN_SEC)
            return

        self.counters["voxels-segmented"].IncrementBy(
            actual_segmented_voxels)
        self.counters["voxels-overlapping"].IncrementBy(
            raw_segmented_voxels - actual_segmented_voxels)

        sid = self.get_next_segment_id()
        self.segmentation[sel][mask] = sid
        if self.keep_probability_maps:
            self.seg_prob[sel][mask] = storage.quantize_probability(
                expit(self.seed[sel][mask]))

        self.log_info("Created supervoxel:%d  seed(zyx):%s  size:%d  "
                      "iters:%d", self._max_id, pos,
                      actual_segmented_voxels, num_iters)
        self.overlaps[self._max_id] = np.array([overlapped_ids, counts])
        self.origins[self._max_id] = storage.OriginInfo(pos, num_iters,
                                                        t_seg)
        self.counters["valid-time-ms"].IncrementBy(t_seg * MSEC_IN_SEC)

    # -- checkpointing (same npz schema as the reference) --------------------

    def restore_checkpoint(self, path: str) -> int:
        """Restores canvas state; returns in-progress segment iterations."""
        self.log_info("Restoring inference checkpoint: %s", path)
        with open(path, "rb") as f:
            data = np.load(f, allow_pickle=True)
            self.segmentation[...] = data["segmentation"]
            self.seed[...] = data["seed"]
            # Rebuild the device buffer from the restored mirror: a copy,
            # since on the CPU as_tensor would alias the mirror.
            self._seed_dev = torch.tensor(self.seed,
                                          device=self.engine.device)
            if self.keep_probability_maps:
                self.seg_prob[...] = data["seg_qprob"]
            self.history_deleted = list(data["history_deleted"])
            self.history = [tuple(h) for h in data["history"]]
            self.origins = storage._read_origins_entry(path)
            if "overlaps" in data:
                self.overlaps = data["overlaps"].item()

            self.counters["voxels-segmented"].Set(
                int(np.sum(self.segmentation != 0)))
            self._max_id = int(np.max(self.segmentation))
            self._min_pos = data["min_pos"]
            self._max_pos = data["max_pos"]
            self.movement_policy.restore_state(data["movement_policy"])
            self._seed_policy_state = data["seed_policy_state"]
            self.counters.loads_np(data["counters"])
            partial = int(data["partial_segment_iters"]) \
                if "partial_segment_iters" in data else 0
            if "hosts" in data:
                self._hosts = list(data["hosts"])
        self.log_info("Inference checkpoint restored.")
        return partial

    def save_checkpoint(self, path: str, partial_segment_iters: int):
        self.log_info("Saving inference checkpoint to %s.", path)
        with timer_counter(self.counters, "save_checkpoint"):
            seed_policy_state = None
            if self.seed_policy is not None:
                seed_policy_state = self.seed_policy.get_state(
                    partial_segment_iters > 0)
            aux = {}
            if self.keep_probability_maps:
                aux["seg_qprob"] = self.seg_prob
            with storage.atomic_file(path) as fd:
                np.savez_compressed(
                    fd,
                    movement_policy=np.asarray(
                        self.movement_policy.get_state(), dtype=object),
                    segmentation=self.segmentation,
                    seed=self.seed,
                    origins=self.origins,
                    overlaps=self.overlaps,
                    min_pos=self._min_pos,
                    max_pos=self._max_pos,
                    history=np.array(self.history),
                    history_deleted=np.array(self.history_deleted),
                    seed_policy_state=np.asarray(seed_policy_state,
                                                 dtype=object),
                    counters=self.counters.dumps_np(),
                    partial_segment_iters=partial_segment_iters,
                    hosts=self._hosts,
                    **aux)
        self.log_info("Inference checkpoint saved.")

    def _maybe_save_checkpoint(self, partial_segment_iters=0):
        if self.checkpoint_path is None or self.checkpoint_interval_sec <= 0:
            return
        if time.time() - self.checkpoint_last < self.checkpoint_interval_sec:
            return
        self.save_checkpoint(self.checkpoint_path,
                             partial_segment_iters=partial_segment_iters)
        self.checkpoint_last = time.time()
