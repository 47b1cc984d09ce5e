"""Local-maximum peak detection with skimage.feature.peak_local_max's
semantics, for the seed policies: candidates equal the maximum over a
(2*min_distance+1)^ndim window (or a footprint); peaks strictly above
max(threshold_abs, threshold_rel * image.max()); exclude_border drops
peaks within min_distance of a border; for p_norm < inf candidates are
thinned greedily in descending intensity to be > min_distance apart.
Plateaus mark every voxel, as skimage's; the policies break ties first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage


def disk_footprint(radius: int) -> np.ndarray:
    """2D disk structuring element (skimage.morphology.disk)."""
    extent = 2 * radius + 1
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(bool)


def _ensure_spacing(coords: np.ndarray, values: np.ndarray,
                    min_distance: float, p_norm: float) -> np.ndarray:
    """Greedy thinning: keep peaks in descending value order, dropping any
    peak within min_distance (p_norm metric) of an already-kept peak."""
    order = np.argsort(-values, kind="stable")
    kept: list[np.ndarray] = []
    for idx in order:
        c = coords[idx]
        ok = True
        for k in kept:
            delta = np.abs(c - k).astype(np.float64)
            if p_norm == np.inf:
                dist = delta.max()
            else:
                dist = (delta ** p_norm).sum() ** (1.0 / p_norm)
            if dist < min_distance:
                ok = False
                break
        if ok:
            kept.append(c)
    if not kept:
        return np.empty((0, coords.shape[1]), dtype=np.int64)
    return np.array(kept, dtype=np.int64)


def peak_local_max(image: np.ndarray, min_distance: int = 1,
                   threshold_abs: Optional[float] = None,
                   threshold_rel: Optional[float] = None,
                   exclude_border=True,
                   footprint: Optional[np.ndarray] = None,
                   p_norm: float = np.inf) -> np.ndarray:
    """Coordinates of local maxima, ordered by descending peak value.

    Returns an (N, ndim) int array.
    """
    image = np.asarray(image)
    if footprint is None:
        size = 2 * min_distance + 1
        max_filt = ndimage.maximum_filter(
            image, size=size, mode="constant", cval=-np.inf)
    else:
        max_filt = ndimage.maximum_filter(
            image, footprint=footprint, mode="constant", cval=-np.inf)

    mask = image == max_filt

    thresholds = []
    if threshold_abs is not None:
        thresholds.append(threshold_abs)
    if threshold_rel is not None:
        thresholds.append(threshold_rel * image.max())
    if thresholds:
        mask &= image > max(thresholds)

    if exclude_border is True:
        border = min_distance
    elif exclude_border is False:
        border = 0
    else:
        border = int(exclude_border)
    if border:
        for axis in range(image.ndim):
            sel = [slice(None)] * image.ndim
            sel[axis] = slice(0, border)
            mask[tuple(sel)] = False
            sel[axis] = slice(image.shape[axis] - border, None)
            mask[tuple(sel)] = False

    coords = np.argwhere(mask)
    if coords.size == 0:
        return np.empty((0, image.ndim), dtype=np.int64)
    values = image[tuple(coords.T)]

    if p_norm != np.inf:
        return _ensure_spacing(coords, values, min_distance, p_norm)

    # Descending peak value, as skimage >= 0.13 returns.
    order = np.argsort(-values, kind="stable")
    return coords[order]


def find_peaks_with_noise(distances: np.ndarray, **kwargs) -> np.ndarray:
    """peak_local_max with the reference's deterministic tie-breaking noise.

    Matches ffn/inference/seed.py:133-139 exactly (RandomState(42),
    rand * 1e-4) so seed ordering is reproducible.
    """
    rng = np.random.RandomState(seed=42)
    return peak_local_max(
        distances + rng.rand(*distances.shape) * 1e-4, **kwargs)
