"""Crop/pad/paste utilities for training canvases (numpy, TF-free).

Parity with the reference's ffn/training/mask.py (update_at :69,
crop_and_pad :102, make_seed :159). Arrays are (b, [z], y, x, c); offsets
are XYZ relative to the array center (center = shape // 2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def update_at(to_update: np.ndarray, offset: Sequence[int],
              new_value: np.ndarray, valid: Optional[np.ndarray] = None):
    """Pastes new_value (centered at center+offset) into to_update, in place."""
    shape = np.array(to_update.shape[1:-1])
    crop_shape = np.array(new_value.shape[1:-1])
    offset = np.array(offset[::-1])

    start = shape // 2 - crop_shape // 2 + offset
    end = start + crop_shape
    assert np.all(start >= 0)

    selector = tuple([slice(None)]
                     + [slice(s, e) for s, e in zip(start, end)]
                     + [slice(None)])
    if valid is not None:
        to_update[selector][valid] = new_value[valid]
    else:
        to_update[selector] = new_value


def crop_and_pad(data: np.ndarray, offset: Sequence[int],
                 crop_shape: Sequence[int],
                 target_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """Extracts crop_shape around center+offset; optionally pads to
    target_shape symmetrically with zeros. Returns a VIEW when no padding
    is needed (callers rely on aliasing for seed write-back)."""
    dim = len(offset)
    shape = np.array(data.shape[-(1 + dim):-1])
    crop_shape = np.array(crop_shape)
    offset = np.array(offset[::-1])

    start = shape // 2 - crop_shape // 2 + offset
    end = start + crop_shape
    num_batch = len(data.shape) - dim - 1
    assert np.all(start >= 0)

    selector = tuple([slice(None)] * num_batch
                     + [slice(s, e) for s, e in zip(start, end)]
                     + [slice(None)])
    cropped = data[selector]

    if target_shape is not None:
        target_shape = np.array(target_shape)
        delta = target_shape - crop_shape
        pre = delta // 2
        post = delta - delta // 2
        paddings = [(0, 0)] * num_batch
        paddings.extend(zip(pre, post))
        paddings.append((0, 0))
        cropped = np.pad(cropped, paddings, mode="constant")
    return cropped


def make_seed(shape, batch_size: int, pad: float = 0.05,
              seed: float = 0.95) -> np.ndarray:
    """(b, z, y, x, 1) float32 canvas with a single active center voxel."""
    seed_array = np.full([batch_size] + list(shape) + [1], pad,
                         dtype=np.float32)
    idx = tuple([slice(None)] + list(np.array(shape) // 2))
    seed_array[idx] = seed
    return seed_array
