"""Segmentation array ops (numpy/scipy): the reference's
ffn/inference/segmentation.py (clear_dust :21, reduce_id_bits :40,
clean_up :63, split_segmentation_by_intersection :145) and the
connectomics `segmentation.labels` helpers it imports (make_contiguous,
split_disconnected_components).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage


def make_contiguous(seg: np.ndarray):
    """Relabels a segmentation to sequential ids starting at 1.

    Returns:
      (relabeled array (int32), list of (old_id, new_id) pairs). 0 and
      negative ids map to themselves (0).
    """
    unique = np.unique(seg)
    positive = unique[unique > 0]
    new_ids = np.arange(1, len(positive) + 1)
    relabeled = np.zeros_like(seg, dtype=np.int32)
    if positive.size:
        # searchsorted-based LUT application over arbitrary id ranges.
        idx = np.searchsorted(positive, seg)
        idx = np.clip(idx, 0, len(positive) - 1)
        hit = positive[idx] == seg
        relabeled[hit] = new_ids[idx[hit]]
    mapping = list(zip((int(x) for x in positive), (int(x) for x in new_ids)))
    return relabeled, mapping


def relabel(seg: np.ndarray, orig_ids: np.ndarray,
            new_ids: np.ndarray) -> np.ndarray:
    """Applies an id mapping to a segmentation (ids not in the map -> 0)."""
    orig_ids = np.asarray(orig_ids)
    new_ids = np.asarray(new_ids)
    order = np.argsort(orig_ids)
    orig_sorted = orig_ids[order]
    new_sorted = new_ids[order]
    out = np.zeros_like(seg, dtype=new_sorted.dtype)
    if orig_sorted.size:
        idx = np.searchsorted(orig_sorted, seg)
        idx = np.clip(idx, 0, len(orig_sorted) - 1)
        hit = orig_sorted[idx] == seg
        out[hit] = new_sorted[idx[hit]]
    return out


def split_disconnected_components(seg: np.ndarray) -> np.ndarray:
    """Relabels so that every spatially connected component (6-connectivity)
    of every id gets its own id. Background (<= 0) stays 0.
    """
    out = np.zeros(seg.shape, dtype=np.int32)
    struct = ndimage.generate_binary_structure(seg.ndim, 1)
    next_id = 1
    # find_objects requires contiguous ids starting at 1.
    clean, _ = make_contiguous(np.where(seg > 0, seg, 0))
    objects = ndimage.find_objects(clean)
    for i, slc in enumerate(objects):
        if slc is None:
            continue
        sid = i + 1
        mask = clean[slc] == sid
        labeled, n = ndimage.label(mask, structure=struct)
        if n == 0:
            continue
        out_view = out[slc]
        out_view[mask] = labeled[mask] + (next_id - 1)
        next_id += n
    return out


def clear_dust(seg: np.ndarray, min_size: int = 10) -> np.ndarray:
    """Zeroes out segments smaller than min_size voxels. In-place; returns seg."""
    ids, sizes = np.unique(seg, return_counts=True)
    small = ids[(sizes < min_size) & (ids > 0)]
    if small.size:
        seg[np.isin(seg, small)] = 0
    return seg


def reduce_id_bits(seg: np.ndarray) -> np.ndarray:
    """Returns seg as the smallest unsigned dtype that fits max(seg)."""
    max_id = int(seg.max()) if seg.size else 0
    if max_id <= np.iinfo(np.uint8).max:
        return seg.astype(np.uint8)
    if max_id <= np.iinfo(np.uint16).max:
        return seg.astype(np.uint16)
    if max_id <= np.iinfo(np.uint32).max:
        return seg.astype(np.uint32)
    return seg.astype(np.uint64)


def clean_up(seg: np.ndarray, split_cc: bool = True, min_size: int = 0,
             return_id_map: bool = False):
    """Splits connected components and removes dust, in place.

    Args:
      seg: segmentation array to clean (modified in place)
      split_cc: whether to relabel spatially disconnected components
      min_size: minimum segment size in voxels (0 disables)
      return_id_map: whether to return {new_id: old_id}

    Returns:
      {new_id: old_id} dict if return_id_map else None.
    """
    if return_id_map:
        old_seg = seg.copy()

    if split_cc:
        contiguous, _mapping = make_contiguous(seg)
        seg[...] = split_disconnected_components(contiguous)
    if min_size > 0:
        clear_dust(seg, min_size=min_size)

    if return_id_map:
        # For every new id, find an old id it came from (they are nested, so
        # any covered voxel gives the unique answer).
        new_ids = np.unique(seg)
        new_ids = new_ids[new_ids > 0]
        new_to_old = {}
        flat_new = seg.ravel()
        flat_old = old_seg.ravel()
        order = np.argsort(flat_new, kind="stable")
        sorted_new = flat_new[order]
        starts = np.searchsorted(sorted_new, new_ids, side="left")
        for nid, pos in zip(new_ids, starts):
            new_to_old[int(nid)] = int(flat_old[order[pos]])
        return new_to_old
    return None


def split_segmentation_by_intersection(a: np.ndarray, b: np.ndarray,
                                       min_size: int = 0) -> None:
    """Computes the intersection (consensus split) of two segmentations.

    Voxels keep a nonzero label iff both inputs are nonzero there; two voxels
    end up in the same output segment iff they had the same (a, b) id pair.
    `a` is relabeled in place (matching the reference's contract,
    ffn/inference/segmentation.py:145-254).
    """
    if a.shape != b.shape:
        raise ValueError("segmentation shapes must match")
    a32 = a.astype(np.uint64)
    b32 = b.astype(np.uint64)
    if a32.max() >= (1 << 32) or b32.max() >= (1 << 32):
        raise ValueError("ids must fit in 32 bits")
    joint = (a32 << np.uint64(32)) | b32
    joint[(a32 == 0) | (b32 == 0)] = 0

    unique, inverse = np.unique(joint, return_inverse=True)
    # Map the zero key to 0 and everything else to 1..N.
    if unique.size and unique[0] == 0:
        new_labels = np.arange(0, unique.size, dtype=np.int64)
    else:
        new_labels = np.arange(1, unique.size + 1, dtype=np.int64)
    out = new_labels[inverse].reshape(a.shape)

    if min_size > 0:
        clear_dust(out, min_size=min_size)
    a[...] = out.astype(a.dtype)
