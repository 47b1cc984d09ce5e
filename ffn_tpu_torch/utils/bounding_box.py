"""Axis-aligned bounding boxes and overlapping subvolume decomposition, at
parity with the reference's ffn/utils/bounding_box.py (BoundingBox :29,
OrderlyOverlappingCalculator :250). Coordinates are XYZ (`to_slice`
flips to ZYX for indexing).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ffn_tpu_torch.proto import bounding_box_pb2
from ffn_tpu_torch.utils import geom


class BoundingBox:
    """Axis-aligned box defined by inclusive start and exclusive end (XYZ)."""

    def __init__(self, start=None, size=None, end=None):
        if start is not None and isinstance(
                start, (bounding_box_pb2.BoundingBox, BoundingBox)):
            if size is not None or end is not None:
                raise ValueError(
                    "a BoundingBox object/proto must be specified alone")
            size = geom.to_numpy3(start.size)
            start = geom.to_numpy3(start.start)

        n_given = (start is not None) + (size is not None) + (end is not None)
        if n_given != 2:
            raise ValueError(
                "exactly two of start, size, end must be specified")

        if start is not None:
            start = geom.to_numpy3(start)
        if size is not None:
            size = geom.to_numpy3(size)
        if end is not None:
            end = geom.to_numpy3(end)

        if start is None:
            start = end - size
        if size is None:
            size = end - start
        self.start: np.ndarray = start
        self.size: np.ndarray = size

    @property
    def end(self) -> np.ndarray:
        """Exclusive end bound (start + size)."""
        return self.start + self.size

    def adjusted_by(self, start=None, end=None) -> "BoundingBox":
        """Returns a new box with offsets added to the start and/or end."""
        new_start = self.start
        new_end = self.end
        if start is not None:
            new_start = new_start + geom.to_numpy3(start)
        if end is not None:
            new_end = new_end + geom.to_numpy3(end)
        return BoundingBox(start=new_start, end=new_end)

    def Sub(self, start=None, end=None, size=None) -> "BoundingBox":
        """Returns a new box with bounds given relative to self.start."""
        if start is None and end is None:
            if size is not None:
                raise ValueError("size requires either start or end")
            return self
        if start is not None and end is not None:
            if size is not None:
                raise ValueError("size must not accompany both start and end")
            start = geom.to_numpy3(start)
            return BoundingBox(self.start + start, geom.to_numpy3(end) - start)
        if start is not None:
            start = geom.to_numpy3(start)
            if size is None:
                size = self.size - start
            return BoundingBox(self.start + start, geom.to_numpy3(size))
        # end only (optionally with size).
        end = geom.to_numpy3(end)
        if size is None:
            return BoundingBox(self.start, end)
        size = geom.to_numpy3(size)
        return BoundingBox(self.start + end - size, size)

    # Lowercase alias.
    sub = Sub

    def to_proto(self) -> bounding_box_pb2.BoundingBox:
        proto = bounding_box_pb2.BoundingBox()
        proto.start.CopyFrom(geom.to_vector3j(self.start))
        proto.size.CopyFrom(geom.to_vector3j(self.size))
        return proto

    def to_slice(self):
        """Returns a ZYX slice tuple for C-order array indexing."""
        return np.index_exp[self.start[2]:self.end[2],
                            self.start[1]:self.end[1],
                            self.start[0]:self.end[0]]

    def to_slice3d(self):
        """Returns a ZYX slice tuple (same as to_slice; the XYZ box is
        flipped for C-order array indexing, matching connectomics
        BoundingBox.to_slice3d semantics)."""
        return self.to_slice()

    def contains(self, point) -> bool:
        point = geom.to_numpy3(point)
        return bool(np.all(point >= self.start) and np.all(point < self.end))

    def __repr__(self):
        return (f"BoundingBox(start={tuple(int(v) for v in self.start)}, "
                f"size={tuple(int(v) for v in self.size)})")

    def __eq__(self, other):
        if isinstance(other, bounding_box_pb2.BoundingBox):
            other = BoundingBox(other)
        elif not isinstance(other, BoundingBox):
            return False
        return bool(np.all(self.start == other.start)
                    and np.all(self.size == other.size))

    def __hash__(self):
        return hash((tuple(self.start), tuple(self.size)))


def intersection(box0, box1) -> Optional[BoundingBox]:
    """Intersection of two boxes, or None if they don't overlap."""
    box0 = BoundingBox(box0) if not isinstance(box0, BoundingBox) else box0
    box1 = BoundingBox(box1) if not isinstance(box1, BoundingBox) else box1
    start = np.maximum(box0.start, box1.start)
    end = np.minimum(box0.end, box1.end)
    if np.any(end <= start):
        return None
    return BoundingBox(start=start, end=end)


def intersections(boxes0: Iterable[BoundingBox],
                  boxes1: Iterable[BoundingBox]) -> list[BoundingBox]:
    """All pairwise non-empty intersections between two box sequences."""
    boxes1 = list(boxes1)
    out = []
    for b0 in boxes0:
        for b1 in boxes1:
            ix = intersection(b0, b1)
            if ix is not None:
                out.append(ix)
    return out


def containing(*boxes) -> BoundingBox:
    """Minimum bounding box containing all given boxes."""
    if not boxes:
        raise ValueError("at least one bounding box required")
    objs = [b if isinstance(b, BoundingBox) else BoundingBox(b) for b in boxes]
    start = objs[0].start
    end = objs[0].end
    for b in objs[1:]:
        start = np.minimum(start, b.start)
        end = np.maximum(end, b.end)
    return BoundingBox(start=start, end=end)


class OrderlyOverlappingCalculator:
    """Decomposes an outer box into overlapping sub-boxes with linear indexing.

    Sub-boxes are enumerable in Fortran order (x fastest) so that contiguous
    indices are spatially adjacent in x; this is the work-distribution
    substrate for sharded whole-volume inference (each index is one work item
    for a chip/host; see ffn_tpu.parallel).
    """

    def __init__(self, outer_box: BoundingBox, sub_box_size: Sequence,
                 overlap: Sequence, include_small_sub_boxes: bool = False,
                 back_shift_small_sub_boxes: bool = False):
        sub_box_size = [outer_box.size[i] if s is None else s
                        for i, s in enumerate(sub_box_size)]
        overlap = np.array(overlap)
        stride = np.array(sub_box_size) - overlap
        if np.any(stride <= 0):
            raise ValueError(
                f"sub_box_size must exceed overlap: {sub_box_size} vs "
                f"{tuple(overlap)}")

        # Trailing boxes smaller than the overlap are fully covered by their
        # predecessor; skip them unless explicitly requested.
        end = outer_box.end if include_small_sub_boxes else \
            outer_box.end - overlap

        self.outer_box = outer_box
        self.start = outer_box.start
        self.stride = stride
        self.end = end
        self.sub_box_size = sub_box_size
        self.back_shift_small_sub_boxes = back_shift_small_sub_boxes
        self.total_sub_boxes_xyz = -((self.start - end) // stride)  # ceil div

    def start_to_box(self, start) -> Optional[BoundingBox]:
        box = BoundingBox(start=start, size=self.sub_box_size)
        if self.back_shift_small_sub_boxes:
            shift = np.maximum(box.end - self.outer_box.end, 0)
            if shift.any():
                return BoundingBox(start=box.start - shift,
                                   size=self.sub_box_size)
            return box
        return intersection(box, self.outer_box)

    def index_to_sub_box(self, index: int) -> Optional[BoundingBox]:
        coords = np.unravel_index(index, self.total_sub_boxes_xyz, order="F")
        return self.start_to_box(np.array(coords) * self.stride + self.start)

    def offset_to_index(self, index: int, offset) -> Optional[int]:
        """Linear index of the sub-box at an xyz offset from `index`."""
        coords = np.array(
            np.unravel_index(index, self.total_sub_boxes_xyz, order="F"))
        coords += np.asarray(offset)
        if np.any(coords < 0) or np.any(coords >= self.total_sub_boxes_xyz):
            return None
        return int(np.ravel_multi_index(
            coords, self.total_sub_boxes_xyz, order="F"))

    def num_sub_boxes(self) -> int:
        return int(self.total_sub_boxes_xyz.astype(object).prod())

    def generate_sub_boxes(self) -> Iterator[BoundingBox]:
        """Yields all sub-boxes in raster (x fastest) order."""
        for z in range(self.start[2], self.end[2], self.stride[2]):
            for y in range(self.start[1], self.end[1], self.stride[1]):
                for x in range(self.start[0], self.end[0], self.stride[0]):
                    box = self.start_to_box((x, y, z))
                    assert box is not None
                    yield box

    def batched_sub_boxes(self, batch_size: int, begin_index: int = 0,
                          end_index: Optional[int] = None):
        """Yields iterables of sub-boxes, batch_size at a time."""
        if end_index is None:
            end_index = self.num_sub_boxes()
        for lo in range(begin_index, end_index, batch_size):
            hi = min(lo + batch_size, end_index)
            yield (self.index_to_sub_box(i) for i in range(lo, hi))

    def tag_border_locations(self, index: int):
        """Returns (is_start, is_end) bool XYZ arrays for outer-box borders."""
        coords = np.array(
            np.unravel_index(index, self.total_sub_boxes_xyz, order="F"))
        return coords == 0, coords == self.total_sub_boxes_xyz - 1
