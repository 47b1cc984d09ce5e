"""Device-resident flood-fill engine: the serial step, the round-based
batched step and the lane reads.

Counterpart of ffn_tpu/inference/engine.py's FloodFillEngine (put_image,
seed buffers and resets, step, select_step, step_batch, _face_scores, the
lane region reads and writes). One serial step is K2 step_gather (patches,
NaN -> pad) -> model.apply (K1, or K15 in bfloat16) -> K3 step_update
(crop, disco mask, write-back), and only the pred-size patch comes back.
One round of B lanes is one (B, 3K+5) int32 upload -> K13 select_gather ->
model.apply on all B lanes -> K14 select_update -> one (B, 30) download.
Lane resets are fills and index sets, as JAX's memsets and scatters. On a
CPU device the kernels' plain versions run.

Seeds are float32 or bfloat16 (`seed_dtype`, FFN_TPU_SEED_DTYPE=bf16,
engine.py:63-67; ops/step.py and ops/select.py say where bfloat16 rounds).
Each call dispatches on its seed tensor's dtype, so a serial seed rebuilt
in float32 by a checkpoint restore stays float32, as in the JAX canvas;
step and step_batch return unrounded float32 patches; downloads are
float32, uploads round into the seed dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ffn_tpu_torch.ops import hop as hop_ops
from ffn_tpu_torch.ops import lane as lane_ops
from ffn_tpu_torch.ops import select as select_ops
from ffn_tpu_torch.ops import step as step_ops


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return device


class FloodFillEngine:
    """Serial and round-based batched flood-fill steps on one device.

    Args:
      model: object with `.apply(image, seed) -> updated_seed` on
        (1, z, y, x, 1) tensors and `.info` (ModelInfo); its parameters
        must already be on `device`.
      pad_value: logit-space value substituted for unvisited (NaN) voxels.
      move_threshold: logit-space move threshold.
      disco_seed_threshold: probability-space threshold from the inference
        options; < 0 disables the disco-seed mask.
      device: where the image, the seed and the model live.
      seed_dtype: torch.float32 or torch.bfloat16, the seed storage.
    """

    def __init__(self, model, *, pad_value: float, move_threshold: float,
                 disco_seed_threshold: float, device="cuda",
                 seed_dtype=torch.float32):
        if seed_dtype not in hop_ops.SEED_DTYPES:
            raise NotImplementedError(
                f"seed dtype {seed_dtype}: ffn_tpu_torch stores seeds in "
                f"float32 or bfloat16, the dtypes the JAX Runner picks "
                f"(ROADMAP.md)")
        self.seed_dtype = seed_dtype
        self.device = resolve_device(device)
        self.model = model
        self.info = model.info
        # The JAX engine carries the three thresholds as one f32 vector.
        self._pad_value = float(np.float32(pad_value))
        self._move_threshold = float(np.float32(move_threshold))
        self._disco_threshold = float(np.float32(disco_seed_threshold))

        # ZYX geometry.
        self._seed_size = tuple(int(v)
                                for v in self.info.input_seed_size[::-1])
        self._image_size = tuple(int(v)
                                 for v in self.info.input_image_size[::-1])
        self._pred_size = tuple(int(v)
                                for v in self.info.pred_mask_size[::-1])
        self._pred_delta = tuple(
            (s - p) // 2 for s, p in zip(self._seed_size, self._pred_size))

    def new_seed_buffer(self, shape) -> torch.Tensor:
        return torch.full(tuple(shape), float("nan"), dtype=self.seed_dtype,
                          device=self.device)

    def put_image(self, image: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(image, dtype=np.float32),
                               device=self.device)

    def reset_seed(self, seed: torch.Tensor, pos, init_activation: float):
        """Clears the seed to NaN and plants init_activation at pos.

        In place; the JAX engine donates the buffer instead.
        """
        seed.fill_(float("nan"))
        seed[tuple(int(p) for p in pos)] = float(np.float32(init_activation))
        return seed

    @torch.no_grad()
    def step(self, image: torch.Tensor, seed: torch.Tensor, pos):
        """One flood-fill step. Returns (seed, patch as np.ndarray).

        `seed` is updated in place and returned, where the JAX engine
        donates its buffer and returns a new one. The patch is the
        pred-size POM update written at `pos` (the caller uses it to update
        its host mirror and the movement policy).
        """
        pos = tuple(int(p) for p in pos)
        image_patch, seed_in = step_ops.step_gather(
            image, seed, pos, self._image_size, self._seed_size,
            self._pad_value)
        logits = self.model.apply(image_patch[None, ..., None],
                                  seed_in[None, ..., None])[0, ..., 0]
        patch = step_ops.step_update(logits.contiguous(), seed, pos,
                                     self._pred_size, self._move_threshold,
                                     self._disco_threshold)
        return seed, patch.cpu().numpy()

    # -- the round-based batched step ----------------------------------------

    def new_seed_batch(self, batch: int, shape) -> torch.Tensor:
        return torch.full((int(batch),) + tuple(shape), float("nan"),
                          dtype=self.seed_dtype, device=self.device)

    def reset_seed_lane(self, seeds: torch.Tensor, lane: int, pos,
                        init_activation: float) -> torch.Tensor:
        """Clears one lane of (B, Z, Y, X) seeds to NaN and plants
        init_activation at pos, in place (engine.py:314-319)."""
        seeds[int(lane)].fill_(float("nan"))
        seeds[(int(lane),) + tuple(int(p) for p in pos)] = float(
            np.float32(init_activation))
        return seeds

    def reset_lanes(self, seeds: torch.Tensor, reset_mask: np.ndarray,
                    pos: np.ndarray, init_activation: float) -> torch.Tensor:
        """Resets the lanes selected by reset_mask (B,) to a fresh seed at
        pos (B, 3), in place (engine.py:295-306)."""
        lanes = np.flatnonzero(np.asarray(reset_mask, bool))
        if not len(lanes):
            return seeds
        p = torch.as_tensor(np.asarray(pos, np.int64).reshape(-1, 3)[lanes],
                            device=self.device)
        idx = torch.as_tensor(lanes, device=self.device)
        seeds.index_fill_(0, idx, float("nan"))
        seeds[idx, p[:, 0], p[:, 1], p[:, 2]] = float(
            np.float32(init_activation))
        return seeds

    @torch.no_grad()
    def _select_round(self, image: torch.Tensor, seeds: torch.Tensor,
                      packed_in: np.ndarray):
        """K13 -> the model on all B lanes -> K14 from the one packed
        (B, 3K+5) int32 upload; returns K14's (packed (B, 30), masked crops
        (B, *pred)) on the device."""
        packed_dev = torch.from_numpy(
            np.ascontiguousarray(packed_in, np.int32)).to(self.device)
        img, seed_in, rec = select_ops.select_gather(
            image, seeds, packed_dev, image_size=self._image_size,
            seed_size=self._seed_size, move_threshold=self._move_threshold,
            pad=self._pad_value)
        logits = self.model.apply(img[..., None], seed_in[..., None])[..., 0]
        return select_ops.select_update(
            logits.contiguous(), seeds, rec, pred_size=self._pred_size,
            deltas=[int(d) for d in self.info.deltas[::-1]],
            move_threshold=self._move_threshold,
            disco_threshold=self._disco_threshold)

    def select_step(self, image: torch.Tensor, seeds: torch.Tensor,
                    candidates: np.ndarray, start_pos: np.ndarray,
                    active: np.ndarray, ignore_threshold: np.ndarray):
        """Batched candidate-selecting step (engine.py:211-293, :359-385).

        Per lane: the first of its K candidates (B, K, 3) whose seed value
        is at or above the move threshold (candidate 0 unconditionally
        where ignore_threshold), the FFN update there if the lane is active
        and its start (B, 3) still holds, and the face maxima of the
        written patch. `seeds` is updated in place and returned with the
        aux dict of host arrays: executed, chosen (-1 if none valid),
        start_ok, scores (B, 6), offsets (B, 6, 3), pos (B, 3). Host
        traffic is one packed upload and one packed download.
        """
        B = candidates.shape[0]
        packed_in = np.concatenate([
            np.asarray(candidates, np.int32).reshape(B, -1),
            np.asarray(start_pos, np.int32).reshape(B, 3),
            np.asarray(active, np.int32).reshape(B, 1),
            np.asarray(ignore_threshold, np.int32).reshape(B, 1),
        ], axis=1)
        packed, _ = self._select_round(image, seeds, packed_in)
        packed = packed.cpu().numpy()
        aux = {
            "executed": packed[:, 0] > 0,
            "chosen": packed[:, 1].astype(np.int32),
            "start_ok": packed[:, 2] > 0,
            "scores": packed[:, 3:9],
            "offsets": packed[:, 9:27].reshape(B, 6, 3).astype(np.int32),
            "pos": packed[:, 27:30].astype(np.int32),
        }
        return seeds, aux

    def step_batch(self, image: torch.Tensor, seeds: torch.Tensor,
                   pos: np.ndarray, active: np.ndarray):
        """Batched step at fixed positions (engine.py:138-175): select_step
        with one candidate, pos (B, 3), taken unconditionally, so a lane
        executes exactly when it is active. `seeds` is updated in place and
        returned with the masked logits (B, *pred) of every lane."""
        pos = np.asarray(pos, np.int32).reshape(-1, 3)
        B = len(pos)
        packed_in = np.concatenate([
            pos, pos, np.asarray(active, np.int32).reshape(B, 1),
            np.ones((B, 1), np.int32)], axis=1)
        _, masked = self._select_round(image, seeds, packed_in)
        return seeds, masked.cpu().numpy()

    def _face_scores(self, patch: torch.Tensor):
        """Face maxima of a pred-size patch (engine.py:177-209).

        Returns (scores (6,), rel_offsets (6, 3) int32); faces ordered
        (z-, z+, y-, y+, x-, x+); faces of zero-delta axes get -inf. The
        plain version of what K6 computes on the card.
        """
        scores, offsets = hop_ops.face_scores_plain(
            patch[None], [int(d) for d in self.info.deltas[::-1]])
        return scores[0], offsets[0]

    @staticmethod
    def _bucket_start(shape, size_zyx, start_zyx):
        """Region sizes bucketed to multiples of 64 (clipped to the volume)
        and the start clamped so the bucket fits (engine.py:424-428). The
        finalize masks depend on exactly these boxes."""
        bucket = tuple(min(s, ((int(v) + 63) // 64) * 64)
                       for v, s in zip(size_zyx, shape))
        start = np.minimum(np.maximum(np.asarray(start_zyx, np.int64), 0),
                           np.array(shape) - np.array(bucket))
        return bucket, start

    def lane_seed_region(self, seeds: torch.Tensor, lane: int, start_zyx,
                         size_zyx):
        """Downloads a sub-box of one lane's seed buffer.

        Returns (region ndarray f32, actual_start); the box is bucketed as
        the JAX engine buckets it (engine.py:415-444). bfloat16 seeds
        download as float32 (exact), as there.
        """
        bucket, start = self._bucket_start(seeds.shape[1:], size_zyx,
                                           start_zyx)
        box = tuple(slice(int(s), int(s) + b) for s, b in zip(start, bucket))
        return seeds[int(lane)][box].float().cpu().numpy().copy(), start

    def lane_mask_region(self, seeds: torch.Tensor, lane: int, start_zyx,
                         size_zyx, seg_threshold: float, start_pos):
        """Thresholded finalization download through K7: the uint8 (seed >=
        threshold) mask of a bucketed sub-box plus the origin's weak-seed
        verdict (engine.py:446-487). NaN thresholds to False.

        Returns (mask uint8 ndarray, actual_start, start_ok bool).
        """
        bucket, start = self._bucket_start(seeds.shape[1:], size_zyx,
                                           start_zyx)
        mask, ok = lane_ops.lane_mask(
            seeds, lane, start, bucket, start_pos, threshold=seg_threshold,
            move_threshold=self._move_threshold)
        return mask.cpu().numpy(), start, bool(ok.cpu()[0])

    def lane_mask_regions(self, seeds: torch.Tensor, lanes, starts_zyx,
                          sizes_zyx, seg_threshold: float, start_positions):
        """Batched lane_mask_region (engine.py:489-552): the masks of every
        candidate lane's bucketed box from one K7 launch and one device->host
        copy. Returns a list of (mask uint8 ndarray, actual_start, start_ok)
        in input order, element i identical to lane_mask_region(lanes[i],
        ...)."""
        boxes = [self._bucket_start(seeds.shape[1:], size, start)
                 for start, size in zip(starts_zyx, sizes_zyx)]
        if not boxes:
            return []
        out = lane_ops.lane_masks(
            seeds, lanes, [s for _, s in boxes], [b for b, _ in boxes],
            start_positions, threshold=seg_threshold,
            move_threshold=self._move_threshold).cpu().numpy()
        n = len(boxes)
        results, at = [], 0
        for j, (bucket, start) in enumerate(boxes):
            size = int(np.prod(bucket))
            results.append((out[at:at + size].reshape(bucket), start,
                            bool(out[len(out) - n + j])))
            at += size
        return results

    def set_lane_seed_region(self, seeds: torch.Tensor, lane: int, start_zyx,
                             region: np.ndarray) -> torch.Tensor:
        """Uploads a sub-box into one lane's seed buffer (checkpoint
        restore), in place. Bucketed like lane_seed_region; the bucket
        padding is NaN, so this must target a freshly-NaN lane
        (engine.py:554-582). The float32 region rounds to nearest even into
        bfloat16 seeds, as `padded.astype(seeds.dtype)` there."""
        bucket, start = self._bucket_start(seeds.shape[1:], region.shape,
                                           start_zyx)
        padded = np.full(bucket, np.nan, np.float32)
        padded[tuple(slice(0, s) for s in region.shape)] = region
        box = tuple(slice(int(s), int(s) + b) for s, b in zip(start, bucket))
        seeds[int(lane)][box] = torch.from_numpy(padded).to(seeds.device,
                                                             seeds.dtype)
        return seeds
