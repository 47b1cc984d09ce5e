"""Device-resident flood-fill engine: the serial step.

Counterpart of the serial part of ffn_tpu/inference/engine.py
(FloodFillEngine: put_image, new_seed_buffer, reset_seed, step). The seed
(POM logits, NaN = unvisited) lives on the device. One step is

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
