"""Training-time data augmentations (numpy, host side), at parity with the
reference's ffn/training/augmentation.py: PermuteAndReflect (:390),
contrast/brightness (:353-387), rotation by grid resampling (:62-281,
scipy map_coordinates). The ssEM section augmentations are not ported
yet (ROADMAP.md). Arrays are (b, z, y, x, c).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage


class PermuteAndReflect:
    """Randomly permutes and reflects a set of spatial axes.

    Equivalent semantics to the reference's PermuteAndReflect: only
    `permutable_axes` may be exchanged with each other, and only
    `reflectable_axes` may be flipped; the same transform is applied to
    every array passed in one __call__ batch (image/labels/weights).
    """

    def __init__(self, rank: int = 5,
                 permutable_axes: Sequence[int] = (2, 3),
                 reflectable_axes: Sequence[int] = (1, 2, 3),
                 rng: Optional[np.random.RandomState] = None):
        self.rank = rank
        self.permutable_axes = list(permutable_axes)
        self.reflectable_axes = list(reflectable_axes)
        self.rng = rng if rng is not None else np.random.RandomState()
        for ax in self.permutable_axes + self.reflectable_axes:
            if not 0 < ax < rank - 1:
                raise ValueError(f"axis {ax} is not a spatial axis")

    def sample(self):
        perm = list(range(self.rank))
        shuffled = list(self.permutable_axes)
        self.rng.shuffle(shuffled)
        for src, dst in zip(self.permutable_axes, shuffled):
            perm[src] = dst
        flips = [ax for ax in self.reflectable_axes
                 if self.rng.rand() < 0.5]
        return tuple(perm), tuple(flips)

    def apply(self, arr: np.ndarray, perm, flips) -> np.ndarray:
        out = np.transpose(arr, perm)
        if flips:
            out = np.flip(out, axis=flips)
        return out

    def __call__(self, *arrays):
        perm, flips = self.sample()
        out = tuple(self.apply(a, perm, flips) for a in arrays)
        return out if len(out) > 1 else out[0]


def random_contrast(image: np.ndarray, rng: np.random.RandomState,
                    lower: float = 0.8, upper: float = 1.2) -> np.ndarray:
    """Scales contrast about the mean by a uniform random factor."""
    factor = rng.uniform(lower, upper)
    mean = image.mean()
    return (image - mean) * factor + mean


def random_brightness(image: np.ndarray, rng: np.random.RandomState,
                      max_delta: float = 0.125) -> np.ndarray:
    return image + rng.uniform(-max_delta, max_delta)


def random_rotation_matrix_3d(rng: np.random.RandomState) -> np.ndarray:
    """Uniformly random 3d rotation (QR of a gaussian matrix)."""
    m = rng.randn(3, 3)
    q, r = np.linalg.qr(m)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def apply_rotation(volume: np.ndarray, matrix: np.ndarray,
                   order: int = 1, mode: str = "nearest") -> np.ndarray:
    """Resamples a (z, y, x) volume through a rotation about its center.

    Replacement for the reference's multidim_image_augmentation
    apply_deformation3d path (augmentation.py:192-281).
    """
    center = (np.array(volume.shape) - 1) / 2.0
    coords = np.indices(volume.shape).reshape(3, -1).astype(np.float64)
    coords -= center[:, None]
    src = matrix.T @ coords + center[:, None]
    out = ndimage.map_coordinates(volume, src, order=order, mode=mode)
    return out.reshape(volume.shape)


def rotation_aware_size(size_zyx, enabled: bool = True) -> np.ndarray:
    """Size to load so that a rotated crop of `size_zyx` has no missing
    data (reference ffn/input/volume.py:140-162)."""
    size = np.asarray(size_zyx)
    if not enabled:
        return size
    diag = int(np.ceil(np.linalg.norm(size)))
    return np.maximum(size, diag)
