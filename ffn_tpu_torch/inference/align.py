"""Identity subvolume alignment.

Counterpart of ffn_tpu/inference/align.py's Alignment, which is identity
there too. The request's alignment type is checked where the request is
converted (settings.InferenceSettings.from_proto).
"""

from __future__ import annotations

import numpy as np


class Alignment:
    """Identity alignment over a subvolume (corner/size are ZYX)."""

    def __init__(self, corner, size):
        self.corner = np.asarray(corner)
        self.size = np.asarray(size)

    def expand_bounds(self, corner, size, forward: bool = True):
        """Expands bounds to grab enough data for (un)alignment. Identity."""
        del forward
        return np.asarray(corner), np.asarray(size)

    def transform(self, points: np.ndarray, forward: bool = True):
        """Transforms a (3, N) array of zyx points. Identity."""
        del forward
        return np.asarray(points)

    def align_and_crop(self, src_corner, image, dst_corner, dst_size,
                       forward: bool = True):
        """Pastes `image` (at src_corner) into a dst_size canvas at dst_corner.

        Voxels of the destination not covered by the source are zero.
        """
        del forward
        src_corner = np.asarray(src_corner)
        dst_corner = np.asarray(dst_corner)
        dst_size = np.asarray(dst_size)
        src_size = np.array(image.shape)

        out = np.zeros(tuple(dst_size), dtype=image.dtype)
        lo = np.maximum(src_corner, dst_corner)
        hi = np.minimum(src_corner + src_size, dst_corner + dst_size)
        if np.any(hi <= lo):
            return out
        src_sel = tuple(slice(int(l - c), int(h - c))
                        for l, h, c in zip(lo, hi, src_corner))
        dst_sel = tuple(slice(int(l - c), int(h - c))
                        for l, h, c in zip(lo, hi, dst_corner))
        out[dst_sel] = image[src_sel]
        return out
