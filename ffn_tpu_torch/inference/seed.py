"""Seed policies: iterators over (z, y, x) starting points. A copy of
ffn_tpu/inference/seed.py without JAX (numpy, scipy, logging). Seed ORDER
decides the segmentation, so the operations keep their sequence (Sobel ->
adaptive threshold -> anisotropic EDT -> noisy peak_local_max ->
ascending zyx; offset-major lattices; the same tie-breaking noise).
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Sequence

import logging

import numpy as np
from scipy import ndimage

from ffn_tpu_torch.ops import edt as edt_lib
from ffn_tpu_torch.ops import peaks as peaks_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.ops import image as image_ops

_EMPTY = np.zeros((0, 3), np.int64)


def _sorted_zyx(coords, reverse: bool = False) -> np.ndarray:
    """Lexicographic (z, y, x) ordering — the canonical seed order."""
    coords = np.asarray(coords)
    if coords.size == 0:
        return _EMPTY
    order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    if reverse:
        order = order[::-1]
    return coords[order]


def _lattice(shape_zyx, step: int, offsets, dense_z: bool) -> np.ndarray:
    """Offset-major (z, y, x)-nested lattice points, vectorized."""
    blocks = []
    for offset in offsets:
        zs = np.arange(0, shape_zyx[0], 1) if dense_z else \
            np.arange(offset, shape_zyx[0], step)
        ys = np.arange(offset, shape_zyx[1], step)
        xs = np.arange(offset, shape_zyx[2], step)
        grid = np.stack(np.meshgrid(zs, ys, xs, indexing="ij"), axis=-1)
        blocks.append(grid.reshape(-1, 3))
    return np.concatenate(blocks) if blocks else _EMPTY


def _stack_slicewise(rows_per_z) -> np.ndarray:
    """Concatenates per-z-slice (y, x) rows into (N, 3) zyx coords."""
    out = []
    for z, yx in rows_per_z:
        yx = np.asarray(yx).reshape(-1, 2)
        if not len(yx):
            continue
        out.append(np.concatenate(
            [np.full((len(yx), 1), z, np.int64), yx], axis=1))
    return np.concatenate(out) if out else _EMPTY


class BaseSeedPolicy:
    """Iterator protocol shared by all policies.

    Subclasses implement init_coords() to fill self.coords with (N, 3)
    zyx points; the base class materializes them lazily on first
    iteration, drops points whose FOV would cross the subvolume border,
    and supports checkpointing through get_state/set_state (a cursor
    into the materialized array).
    """

    def __init__(self, canvas, **kwargs):
        logging.info("Deleting unused BaseSeedPolicy kwargs: %s", kwargs)
        del kwargs
        self.canvas = weakref.proxy(canvas)
        self.coords: np.ndarray | None = None  # (N, 3), zyx
        self.idx = 0

    def init_coords(self):
        raise NotImplementedError()

    def _materialize(self):
        self.init_coords()
        if self.coords is None or not self.coords.size:
            self.coords = _EMPTY
            return
        margin = np.asarray(self.canvas.margin)
        shape = np.asarray(self.canvas.shape)
        keep = np.all((self.coords >= margin)
                      & (self.coords + margin < shape), axis=1)
        self.coords = self.coords[keep]

    def __iter__(self):
        return self

    def __next__(self):
        """Next seed point as a (z, y, x) int tuple."""
        if self.coords is None:
            self._materialize()
        if self.idx >= len(self.coords):
            raise StopIteration()
        pos = self.coords[self.idx]
        self.idx += 1
        return tuple(int(v) for v in pos)

    def draw_batch(self, k: int) -> np.ndarray:
        """Advances the cursor by up to k and returns the drawn block as
        an (m, 3) array — the vectorized equivalent of m next() calls
        (per-candidate iteration was a measured supply bottleneck for
        the batched drivers). m < k means the policy is exhausted."""
        if self.coords is None:
            self._materialize()
        batch = self.coords[self.idx:self.idx + int(k)]
        self.idx += len(batch)
        return batch

    def get_state(self, previous=False):
        """Pickleable (coords, cursor); `previous` rewinds one seed for
        in-progress segment checkpointing."""
        return self.coords, max(0, self.idx - 1) if previous else self.idx

    def set_state(self, state):
        self.coords, self.idx = state

    def get_exclusion_mask(self):
        """Voxels invalid for seeding (already segmented or masked)."""
        mask = self.canvas.segmentation > 0
        restrictor = self.canvas.restrictor
        if restrictor is not None:
            for extra in (restrictor.mask, restrictor.seed_mask):
                if extra is not None:
                    mask |= extra
        return mask


_find_peaks = peaks_lib.find_peaks_with_noise


class PolicyPeaks(BaseSeedPolicy):
    """Peaks of the distance transform of adaptive-thresholded edges.

    The flagship policy. Operation sequence pinned to the reference
    (seed.py:142-199): 3d Sobel -> Gaussian adaptive threshold ->
    anisotropic EDT of the non-edge space -> peak_local_max with
    deterministic tie-breaking noise -> ascending zyx.
    """

    # Bound concurrent peak computations (temporary memory spike).
    _sem = threading.Semaphore(4)

    def init_coords(self):
        logging.info("peaks: starting")
        filt_edges = image_ops.adaptive_edge_mask(
            np.asarray(self.canvas.image, dtype=np.float32))

        mask = self.get_exclusion_mask()

        # Prevent border effects in the distance transform.
        restrictor = self.canvas.restrictor
        if restrictor is not None:
            for extra in (restrictor.mask, restrictor.seed_mask):
                if extra is not None:
                    filt_edges[extra] = 1

        if np.all(filt_edges == 1):
            return

        with PolicyPeaks._sem:
            logging.info("peaks: filtering done")
            dt = edt_lib.edt(1 - filt_edges,
                             anisotropy=self.canvas.voxel_size_zyx
                             ).astype(np.float32)
            logging.info("peaks: edt done")
            dt[mask] = -1
            dt[~np.isfinite(dt)] = -1

            idxs = _find_peaks(dt, min_distance=3, threshold_abs=0,
                               threshold_rel=0)
            self.coords = _sorted_zyx(idxs)
            logging.info("peaks: found %d local maxima",
                         len(self.coords))


class PolicyPeaks2d(BaseSeedPolicy):
    """Per-z-slice 2d edge-distance peaks, globally zyx-sorted."""

    def __init__(self, canvas, min_distance=7, threshold_abs=2.5,
                 sort_cmp="ascending", **kwargs):
        super().__init__(canvas, **kwargs)
        self.min_distance = min_distance
        self.threshold_abs = threshold_abs
        self.sort_reverse = sort_cmp.strip().lower().startswith("de")

    def _slice_peaks(self, z: int) -> np.ndarray:
        image_2d = np.asarray(self.canvas.image[z], dtype=np.float32)
        filt_edges = image_ops.adaptive_edge_mask(image_2d)
        restrictor = self.canvas.restrictor
        if restrictor is not None and restrictor.mask is not None:
            filt_edges[restrictor.mask[z]] = 1
        dt = edt_lib.edt(1 - filt_edges).astype(np.float32)
        return _find_peaks(dt, min_distance=self.min_distance,
                           threshold_abs=self.threshold_abs,
                           threshold_rel=0)

    def init_coords(self):
        logging.info("2d peaks: starting")
        self.coords = _sorted_zyx(_stack_slicewise(
            (z, self._slice_peaks(z))
            for z in range(self.canvas.image.shape[0])),
            reverse=self.sort_reverse)
        logging.info("2d peaks: found %d total local maxima",
                     len(self.coords))


class PolicyFillEmptySpace(BaseSeedPolicy):
    """Peaks of the distance transform of unsegmented space."""

    def init_coords(self):
        dt = edt_lib.edt(self.canvas.segmentation == 0).astype(np.float32)
        # threshold_abs < 1 avoids seeding inside already-segmented areas.
        self.coords = _sorted_zyx(_find_peaks(
            dt, min_distance=2, threshold_abs=0.5, threshold_rel=0))


class PolicyMax(BaseSeedPolicy):
    """All points, in descending order of image intensity."""

    def init_coords(self):
        img = np.asarray(self.canvas.image)
        order = np.argsort(img.flat)[::-1]
        self.coords = np.stack(
            np.unravel_index(order, img.shape), axis=1)


class PolicyMaxPeaks(BaseSeedPolicy):
    """Local peaks of image intensity."""

    def __init__(self, canvas, min_distance=3, threshold_abs=0,
                 threshold_rel=0, **kwargs):
        super().__init__(canvas, **kwargs)
        self.min_distance = min_distance
        self.threshold_abs = threshold_abs
        self.threshold_rel = threshold_rel

    def init_coords(self):
        img = np.asarray(self.canvas.image, dtype=np.float32).copy()
        img[self.get_exclusion_mask()] = 0
        self.coords = _sorted_zyx(_find_peaks(
            img, min_distance=self.min_distance,
            threshold_abs=self.threshold_abs,
            threshold_rel=self.threshold_rel))


class PolicyImagePeaks3D2D(BaseSeedPolicy):
    """3d image peaks first, then per-slice 2d image peaks."""

    def __init__(self, canvas, min_distance_2d=2, min_distance_3d=4,
                 **kwargs):
        super().__init__(canvas, **kwargs)
        self._min_distance_2d = min_distance_2d
        self._min_distance_3d = min_distance_3d

    def init_coords(self):
        img = np.asarray(self.canvas.image)
        parts = []
        if self._min_distance_3d >= 0:
            parts.append(np.asarray(peaks_lib.peak_local_max(
                img, min_distance=self._min_distance_3d)).reshape(-1, 3))
        if self._min_distance_2d >= 0:
            parts.append(_stack_slicewise(
                (z, peaks_lib.peak_local_max(
                    img[z], min_distance=self._min_distance_2d))
                for z in range(img.shape[0])))
        self.coords = np.concatenate(parts) if parts else _EMPTY


class PolicyImagePeaks2DDisk(BaseSeedPolicy):
    """2d image peaks with a disk footprint and euclidean spacing."""

    def __init__(self, canvas, min_distance_2d=3, threshold_rel=0.5,
                 disk_radius=1, **kwargs):
        super().__init__(canvas, **kwargs)
        self._min_distance_2d = min_distance_2d
        self._threshold_rel = threshold_rel
        self._disk_radius = disk_radius

    def init_coords(self):
        img = np.asarray(self.canvas.image)
        footprint = peaks_lib.disk_footprint(self._disk_radius)
        self.coords = _stack_slicewise(
            (z, peaks_lib.peak_local_max(
                img[z], min_distance=self._min_distance_2d, p_norm=2,
                threshold_rel=self._threshold_rel, exclude_border=True,
                footprint=footprint))
            for z in range(img.shape[0]))


class PolicyGrid3d(BaseSeedPolicy):
    """Uniform 3d lattice, several interleaved offsets (coarse first)."""

    def __init__(self, canvas, step=16, offsets=(0, 8, 4, 12, 2, 10, 14),
                 **kwargs):
        super().__init__(canvas, **kwargs)
        self.step = step
        self.offsets = offsets

    def init_coords(self):
        self.coords = _lattice(self.canvas.image.shape, self.step,
                               self.offsets, dense_z=False)


class PolicyGrid2d(BaseSeedPolicy):
    """Uniform lattice in y/x on EVERY z slice."""

    def __init__(self, canvas, step=16, offsets=(0, 8, 4, 12, 2, 6, 10, 14),
                 **kwargs):
        super().__init__(canvas, **kwargs)
        self.step = step
        self.offsets = offsets

    def init_coords(self):
        self.coords = _lattice(self.canvas.image.shape, self.step,
                               self.offsets, dense_z=True)


class PolicyInvertOrigins(BaseSeedPolicy):
    """Origins of a previous run, in reverse order."""

    def __init__(self, canvas, corner=None, segmentation_dir=None, **kwargs):
        super().__init__(canvas, **kwargs)
        self.corner = corner
        self.segmentation_dir = segmentation_dir

    def init_coords(self):
        origins = storage.load_origins(self.segmentation_dir, self.corner)
        points = sorted(origins.items(), reverse=True)
        self.coords = np.array([origin_info.start_zyx
                                for _, origin_info in points])


class PolicyDenseSeeds(BaseSeedPolicy):
    """Every voxel of a thresholded (optionally eroded) image."""

    def __init__(self, canvas: Any, threshold: float = 0.5,
                 num_erosions: int = 0, invert: bool = False, **kwargs):
        super().__init__(canvas, **kwargs)
        self._threshold = threshold
        self._num_erosions = num_erosions
        self._invert = invert

    def init_coords(self):
        x = np.asarray(self.canvas.image) > self._threshold
        if self._invert:
            x = ~x
        for _ in range(self._num_erosions):
            x = ndimage.binary_erosion(x)
        self.coords = np.argwhere(x)


class ReverseCoords(BaseSeedPolicy):
    """Wraps another policy, reversing its seed order."""

    def __init__(self, canvas, policy_to_reverse: str, **policy_kwargs):
        super().__init__(canvas)
        self._policy = globals()[policy_to_reverse](canvas,
                                                    **policy_kwargs)

    def init_coords(self):
        inner = np.asarray(list(self._policy)).reshape(-1, 3)
        self.coords = inner[::-1]


class SequentialPolicies(BaseSeedPolicy):
    """Chains several policies in sequence."""

    def __init__(self, canvas,
                 policies: Sequence[tuple[str, dict[str, Any]]], **kwargs):
        del kwargs
        super().__init__(canvas)
        self._policies = [globals()[name](canvas, **kw)
                          for name, kw in policies]

    def init_coords(self):
        parts = [np.asarray(list(p)).reshape(-1, 3)
                 for p in self._policies]
        self.coords = np.concatenate(parts) if parts else _EMPTY

    def get_state(self, previous=False):
        return [p.get_state(previous=previous) for p in self._policies]

    def set_state(self, state):
        for s, policy in zip(state, self._policies):
            policy.set_state(s)


class PolicyNeighborOriginsThenPeaks(BaseSeedPolicy):
    """Seed handoff (ffn_tpu/parallel/sharded_inference.py:34-70): the
    origins of finished neighboring subvolumes, translated into this
    subvolume's frame, come before the PolicyPeaks seeds, so objects that
    cross a border start from the same point on both sides."""

    def __init__(self, canvas, corner=None, subvol_size=None,
                 segmentation_dir=None, neighbor_corners=(), **kwargs):
        super().__init__(canvas, **kwargs)
        self._corner = np.asarray(corner)          # zyx
        self._size = np.asarray(subvol_size)
        self._segmentation_dir = segmentation_dir
        self._neighbor_corners = [np.asarray(c) for c in neighbor_corners]
        self._peaks = PolicyPeaks(canvas)
        self.num_handoff = 0

    def init_coords(self):
        handoff = []
        for nbr_corner in self._neighbor_corners:
            try:
                origins = storage.load_origins(self._segmentation_dir,
                                               tuple(nbr_corner))
            except ValueError:
                continue
            for info in origins.values():
                local = np.asarray(info.start_zyx) + nbr_corner \
                    - self._corner
                if np.all(local >= 0) and np.all(local < self._size):
                    handoff.append(local)
        self._peaks.init_coords()
        peak_coords = self._peaks.coords
        if peak_coords is None:
            peak_coords = _EMPTY
        self.num_handoff = len(handoff)
        self.coords = np.concatenate(
            [np.array(handoff, np.int64), peak_coords]) if handoff \
            else peak_coords
