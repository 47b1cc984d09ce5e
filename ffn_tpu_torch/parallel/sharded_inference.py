"""Sharded inference (ffn_tpu/parallel/sharded_inference.py): subvolumes of
an OrderlyOverlappingCalculator assigned to workers by linear index
(finished ones skipped, so retries are safe), optional seed handoff (the
origins of finished neighbours first: PolicyNeighborOriginsThenPeaks),
and overlap stitching into a global id space (parallel/stitching.py). A
worker is one process on one device; `run_worker_fused` runs its
subvolumes through one lane batch (parallel/multi_canvas.py).
"""

from __future__ import annotations

import functools
import json
import logging
from typing import Optional, Sequence

from ffn_tpu_torch.inference import runner as runner_lib
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.utils import bounding_box


class ShardedInferenceDriver:
    """Runs (a shard of) a decomposed whole-volume inference on `device`.
    `canvas_defaults` (e.g. max_iters_per_segment) go to the Runner it
    builds when run_worker* is given none."""

    def __init__(self, request, outer_box: bounding_box.BoundingBox,
                 subvol_size_xyz: Sequence[int],
                 overlap_xyz: Sequence[int],
                 seed_handoff: bool = True, device="cuda",
                 canvas_defaults=None):
        self.request = request
        self.canvas_defaults = dict(canvas_defaults or {})
        self.calc = bounding_box.OrderlyOverlappingCalculator(
            outer_box, list(subvol_size_xyz), list(overlap_xyz))
        self.seed_handoff = seed_handoff
        self.device = device
        self.fused_stats = None

    def num_subvolumes(self) -> int:
        return self.calc.num_sub_boxes()

    def _box(self, index):
        """(corner, size) of subvolume `index`, both zyx."""
        box = self.calc.index_to_sub_box(index)
        return (tuple(int(v) for v in box.start[::-1]),
                tuple(int(v) for v in box.size[::-1]))

    def pending_indices(self) -> list[int]:
        """Indices whose output npz does not exist yet."""
        return [index for index in range(self.calc.num_sub_boxes())
                if not storage.get_existing_subvolume_path(
                    self.request.segmentation_output_dir,
                    self._box(index)[0])]

    def _neighbor_corners(self, index) -> list[tuple]:
        corners = []
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == dy == dz == 0:
                        continue
                    nbr = self.calc.offset_to_index(index, (dx, dy, dz))
                    if nbr is not None:
                        corners.append(self._box(nbr)[0])
        return corners

    def _runner(self, runner):
        if runner is None:
            runner = runner_lib.Runner(device=self.device)
            runner.canvas_defaults.update(self.canvas_defaults)
            runner.start(self.request)
        return runner

    def _handoff_kwargs(self, runner, index):
        kwargs = (json.loads(runner.request.seed_policy_args)
                  if runner.request.seed_policy_args else {})
        kwargs["segmentation_dir"] = runner.request.segmentation_output_dir
        kwargs["neighbor_corners"] = [list(map(int, c)) for c in
                                      self._neighbor_corners(index)]
        return kwargs

    def run_worker(self, worker_id: int = 0, num_workers: int = 1,
                   runner: Optional[runner_lib.Runner] = None):
        """Processes every subvolume with index % num_workers == worker_id,
        one at a time."""
        runner = self._runner(runner)
        processed = 0
        for index in range(worker_id, self.calc.num_sub_boxes(),
                           num_workers):
            corner, size = self._box(index)
            if self.seed_handoff:
                runner.request.seed_policy = "PolicyNeighborOriginsThenPeaks"
                runner.request.seed_policy_args = json.dumps(
                    self._handoff_kwargs(runner, index))
            if runner.run(corner, size) is not None:
                processed += 1
            logging.info("worker %d: subvolume %d/%d done", worker_id,
                         index, self.calc.num_sub_boxes())
        return processed

    def run_worker_fused(self, worker_id: int = 0, num_workers: int = 1,
                         runner: Optional[runner_lib.Runner] = None,
                         lanes: int = 64, slots: int = 4, hops: int = 16,
                         keep_probability_maps: bool = False,
                         device_finalize: bool = True, mesh=None) -> int:
        """Processes this worker's subvolumes concurrently in one lane batch
        (parallel/multi_canvas.py), with run_worker's outputs and
        idempotency. Returns the number of subvolumes saved."""
        from ffn_tpu_torch.parallel import multi_canvas

        runner = self._runner(runner)
        tasks, corner_to_index = [], {}
        for index in range(worker_id, self.calc.num_sub_boxes(),
                           num_workers):
            corner, size = self._box(index)
            tasks.append((corner, size))
            corner_to_index[corner] = index
        if not tasks:
            return 0
        if self.seed_handoff:
            # One handoff policy per slot: neighbors finished in this run
            # or an earlier one donate their origins.
            def get_seed_policy(corner, subvol_size):
                index = corner_to_index[tuple(int(v) for v in corner)]
                return functools.partial(
                    seed_lib.PolicyNeighborOriginsThenPeaks, corner=corner,
                    subvol_size=subvol_size,
                    **self._handoff_kwargs(runner, index))

            runner.get_seed_policy = get_seed_policy

        driver = multi_canvas.MultiSubvolumeHopDriver(
            runner, tasks, lanes=lanes, slots=slots, hops=hops,
            keep_probability_maps=keep_probability_maps,
            device_finalize=device_finalize, mesh=mesh)
        saved = driver.run()
        self.fused_stats = driver.stats   # the last fused run's stats
        return saved

    def stitch(self, min_overlap_fraction: float = 0.5):
        """Builds the global ID space over all finished subvolumes."""
        from ffn_tpu_torch.parallel import stitching
        return stitching.SubvolumeStitcher(
            self.calc, self.request.segmentation_output_dir,
            min_overlap_fraction).build()
