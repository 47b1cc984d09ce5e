"""Global id reconciliation of subvolume segmentations, a copy of
ffn_tpu/parallel/stitching.py on the port's helpers: neighbours' ids
matched in their overlaps by mutual-majority voxel overlap, merged
(union-find) into one volume.
"""

from __future__ import annotations

import logging

import numpy as np

from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.utils import bounding_box
from ffn_tpu_torch.utils import labels as labels_lib


class UnionFind:
    """Union-find over hashable keys: iterative path halving + union by
    size, so pod-scale merge chains neither recurse past Python's stack
    limit nor degenerate to linear walks."""

    def __init__(self):
        self.parent = {}
        self._size = {}

    def find(self, key):
        parent = self.parent.setdefault(key, key)
        if parent == key:
            self._size.setdefault(key, 1)
            return key
        while self.parent[key] != key:
            self.parent[key] = self.parent[self.parent[key]]
            key = self.parent[key]
        return key

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self._size[ra] < self._size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self._size[ra] += self._size[rb]


def match_ids_in_overlap(seg_a: np.ndarray, seg_b: np.ndarray,
                         min_overlap_fraction: float = 0.5):
    """Matches ids between two aligned overlap crops.

    A pair (a, b) matches when each is the mutual-majority partner of the
    other within the overlap (fraction of a's overlap voxels labeled b in
    seg_b >= min_overlap_fraction, and vice versa).

    Returns a list of (id_a, id_b) pairs.
    """
    counts = labels_lib.compute_overlap_counts(seg_a, seg_b)
    totals_a = {}
    totals_b = {}
    for (a, b), c in counts.items():
        if a:
            totals_a[a] = totals_a.get(a, 0) + c
        if b:
            totals_b[b] = totals_b.get(b, 0) + c

    pairs = []
    for (a, b), c in counts.items():
        if not a or not b:
            continue
        if (c / totals_a[a] >= min_overlap_fraction
                and c / totals_b[b] >= min_overlap_fraction):
            pairs.append((int(a), int(b)))
    return pairs


class SubvolumeStitcher:
    """Builds a global ID space over an OrderlyOverlappingCalculator grid."""

    def __init__(self, calc: bounding_box.OrderlyOverlappingCalculator,
                 segmentation_dir: str,
                 min_overlap_fraction: float = 0.5):
        self.calc = calc
        self.segmentation_dir = segmentation_dir
        self.min_overlap_fraction = min_overlap_fraction
        self.uf = UnionFind()
        self._global_ids = None

    def _corner(self, box) -> tuple:
        return tuple(int(v) for v in box.start[::-1])  # zyx

    def _load(self, box):
        corner = self._corner(box)
        try:
            seg, _ = storage.load_segmentation(
                self.segmentation_dir, corner, split_cc=False)
        except ValueError:
            return None
        return seg

    def build(self):
        """Scans all +x/+y/+z neighbor pairs and unions matching ids.

        Single pass, each subvolume loaded exactly ONCE: when a subvolume
        is loaded, its overlap crops with +axis neighbors are stored
        (small boundary slabs, not full volumes) and matched against the
        stored slabs of its -axis predecessors, which are then released.
        Peak memory is one x-slab + one row of y-slabs + one plane of
        z-slabs — independent of the grid's total size.
        """
        num = self.calc.num_sub_boxes()
        pending = {}  # (pred_index, this_index) -> pred's overlap crop

        def drop_pending_for(index):
            for axis_offset in ((-1, 0, 0), (0, -1, 0), (0, 0, -1)):
                pred = self.calc.offset_to_index(index, axis_offset)
                if pred is not None:
                    pending.pop((pred, index), None)

        for index in range(num):
            box = self.calc.index_to_sub_box(index)
            seg = self._load(box)
            if seg is None:
                drop_pending_for(index)
                continue
            # Register all ids so isolated segments get global ids too.
            for sid in np.unique(seg):
                if sid > 0:
                    self.uf.find((index, int(sid)))

            # Match against predecessors whose slabs are waiting on us.
            for axis_offset in ((-1, 0, 0), (0, -1, 0), (0, 0, -1)):
                pred_index = self.calc.offset_to_index(index, axis_offset)
                if pred_index is None:
                    continue
                crop_pred = pending.pop((pred_index, index), None)
                if crop_pred is None:
                    continue
                pred_box = self.calc.index_to_sub_box(pred_index)
                overlap = bounding_box.intersection(box, pred_box)
                crop_here = self._crop(seg, box, overlap)
                for id_p, id_h in match_ids_in_overlap(
                        crop_pred, crop_here, self.min_overlap_fraction):
                    self.uf.union((pred_index, id_p), (index, id_h))

            # Stash this subvolume's slabs for its +axis successors.
            for axis_offset in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                nbr_index = self.calc.offset_to_index(index, axis_offset)
                if nbr_index is None:
                    continue
                nbr_box = self.calc.index_to_sub_box(nbr_index)
                overlap = bounding_box.intersection(box, nbr_box)
                if overlap is None:
                    continue
                pending[(index, nbr_index)] = self._crop(seg, box,
                                                         overlap).copy()

        # Assign dense global ids to union roots.
        self._global_ids = {}
        next_id = 1
        for key in list(self.uf.parent):
            root = self.uf.find(key)
            if root not in self._global_ids:
                self._global_ids[root] = next_id
                next_id += 1
        logging.info("stitching: %d local ids -> %d global segments",
                     len(self.uf.parent), next_id - 1)
        return self

    def _crop(self, seg, box, overlap):
        rel = bounding_box.BoundingBox(
            start=overlap.start - box.start, size=overlap.size)
        return seg[rel.to_slice()]

    def global_id(self, index: int, local_id: int) -> int:
        assert self._global_ids is not None, "call build() first"
        if local_id <= 0:
            return 0
        return self._global_ids[self.uf.find((index, int(local_id)))]

    def relabel(self, index: int, seg: np.ndarray) -> np.ndarray:
        """Relabels a subvolume's segmentation into the global id space."""
        ids = np.unique(seg)
        ids = ids[ids > 0]
        out_ids = np.array([self.global_id(index, int(i)) for i in ids],
                           np.uint64)
        from ffn_tpu_torch.inference import segmentation as seg_lib
        return seg_lib.relabel(seg, ids, out_ids)

    def assemble(self, output) -> np.ndarray | None:
        """Writes the stitched global segmentation.

        Args:
          output: either a numpy/h5py dataset of the outer box shape (zyx)
            or None, in which case a new uint64 ndarray is returned.
        """
        outer = self.calc.outer_box
        if output is None:
            output = np.zeros(tuple(outer.size[::-1]), np.uint64)
        for index in range(self.calc.num_sub_boxes()):
            box = self.calc.index_to_sub_box(index)
            seg = self._load(box)
            if seg is None:
                continue
            relabeled = self.relabel(index, seg)
            # Write the full subvolume; later (higher-index) subvolumes
            # win in the overlap except where they are background.
            rel = bounding_box.BoundingBox(
                start=box.start - outer.start, size=box.size)
            sel = rel.to_slice()
            region = output[sel]
            write = relabeled != 0
            region[write] = relabeled[write]
            output[sel] = region
        return output
