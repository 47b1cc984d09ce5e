"""Deterministic rule-based FFN model for tests and smoke runs.

Counterpart of ffn_tpu/models/oracle.py.
"""

from __future__ import annotations

import torch
from torch import nn

from ffn_tpu.models import model_info as model_info_lib


class ThresholdOracleModel(nn.Module):
    """Predicts +logit_scale where image > threshold, else -logit_scale.

    Flood fill then covers exactly the connected component of
    {image > threshold} reachable by the movement policy. Ignores the seed.
    """

    dim = 3

    def __init__(self, fov_size=None, deltas=None, batch_size=None,
                 threshold: float = 0.0, logit_scale: float = 10.0,
                 **kwargs):
        super().__init__()
        del kwargs
        self.info = model_info_lib.ModelInfo(
            deltas=deltas, pred_mask_size=fov_size,
            input_seed_size=fov_size, input_image_size=fov_size,
            additive=False)
        self.batch_size = batch_size
        self.threshold = threshold
        self.logit_scale = logit_scale

    def apply(self, image: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        del seed
        pos = torch.full_like(image, self.logit_scale, dtype=torch.float32)
        return torch.where(image > self.threshold, pos, -pos)
