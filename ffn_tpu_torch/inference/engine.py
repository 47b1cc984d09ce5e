"""Device-resident flood-fill engine: the serial step and the lane reads.

Counterpart of ffn_tpu/inference/engine.py's FloodFillEngine: put_image,
new_seed_buffer, reset_seed and step for the serial canvas; _face_scores,
lane_seed_region, lane_mask_region (K7) and set_lane_seed_region for the
batched hop path. The seed (POM logits, NaN = unvisited) lives on the
device. One serial step is

  K2 step_gather (image and seed patches, NaN -> pad)
  -> model.apply (the conv stack: K1 for every layer)
  -> K3 step_update (crop, disco-seed mask, write-back)

and only the pred-size patch comes back to the host, for the canvas's
mirror and the movement policy. On a CPU device the same calls run the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ffn_tpu_torch.ops import hop as hop_ops
from ffn_tpu_torch.ops import lane as lane_ops
from ffn_tpu_torch.ops import step as step_ops


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return device


class FloodFillEngine:
    """Serial flood-fill step on one device.

    Args:
      model: object with `.apply(image, seed) -> updated_seed` on
        (1, z, y, x, 1) tensors and `.info` (ModelInfo); its parameters
        must already be on `device`.
      pad_value: logit-space value substituted for unvisited (NaN) voxels.
      move_threshold: logit-space move threshold.
      disco_seed_threshold: probability-space threshold from the inference
        options; < 0 disables the disco-seed mask.
      device: where the image, the seed and the model live.
    """

    def __init__(self, model, *, pad_value: float, move_threshold: float,
                 disco_seed_threshold: float, device="cuda"):
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
        return torch.full(tuple(shape), float("nan"), dtype=torch.float32,
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
        the JAX engine buckets it (engine.py:415-444).
        """
        bucket, start = self._bucket_start(seeds.shape[1:], size_zyx,
                                           start_zyx)
        box = tuple(slice(int(s), int(s) + b) for s, b in zip(start, bucket))
        return seeds[int(lane)][box].cpu().numpy().copy(), start

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

    def set_lane_seed_region(self, seeds: torch.Tensor, lane: int, start_zyx,
                             region: np.ndarray) -> torch.Tensor:
        """Uploads a sub-box into one lane's seed buffer (checkpoint
        restore), in place. Bucketed like lane_seed_region; the bucket
        padding is NaN, so this must target a freshly-NaN lane
        (engine.py:554-582)."""
        bucket, start = self._bucket_start(seeds.shape[1:], region.shape,
                                           start_zyx)
        padded = np.full(bucket, np.nan, np.float32)
        padded[tuple(slice(0, s) for s in region.shape)] = region
        box = tuple(slice(int(s), int(s) + b) for s, b in zip(start, bucket))
        seeds[int(lane)][box] = torch.from_numpy(padded).to(seeds.device)
        return seeds
