"""FFN field-of-view movement policies.

Counterpart of ffn_tpu/inference/movement.py: get_scored_move_offsets,
FaceMaxMovementPolicy (FIFO deque + delta-quantized dedup) and
MovementRestrictor with voxel masks (shift masks are not ported yet). All
coordinate triples are ZYX.
"""

from __future__ import annotations

import json
import weakref
from collections import deque
from typing import Optional

import numpy as np
from scipy.special import logit

from ffn_tpu_torch.models import registry


def get_scored_move_offsets(deltas, prob_map, threshold=0.9):
    """Yields (score, (z, y, x) offset) moves from cuboid-face maxima.

    For each axis with delta > 0 and each direction, takes the plane of the
    probability map at +/-delta from the center, finds its maximum, and
    yields the move to that voxel if the maximum clears the threshold.
    Offsets are relative to the center of prob_map.
    """
    center = np.array(prob_map.shape) // 2
    assert center.size == 3
    subvol_sel = [slice(c - dx, c + dx + 1)
                  for c, dx in zip(center, deltas)]

    done = set()
    for axis, axis_delta in enumerate(deltas):
        if axis_delta == 0:
            continue
        for axis_offset in (-axis_delta, axis_delta):
            face_sel = subvol_sel[:]
            face_sel[axis] = axis_offset + center[axis]
            face_prob = prob_map[tuple(face_sel)]
            shape = face_prob.shape

            face_pos = np.unravel_index(face_prob.argmax(), shape)
            score = face_prob[face_pos]
            if score < threshold:
                continue

            relative_pos = [face_pos[0] - shape[0] // 2,
                            face_pos[1] - shape[1] // 2]
            relative_pos.insert(axis, axis_offset)
            ret = (score, tuple(relative_pos))
            if ret not in done:
                done.add(ret)
                yield ret


class BaseMovementPolicy:
    """Base class for movement policy queues."""

    def __init__(self, canvas, scored_coords, deltas):
        self.canvas = weakref.proxy(canvas)
        self.scored_coords = scored_coords
        self.deltas = np.array(deltas)

    def __len__(self):
        return len(self.scored_coords)

    def __iter__(self):
        return self

    def __next__(self):
        raise StopIteration()

    def append(self, item):
        self.scored_coords.append(item)

    def update(self, prob_map, position):
        raise NotImplementedError()

    def get_state(self):
        raise NotImplementedError()

    def restore_state(self, state):
        raise NotImplementedError()

    def reset_state(self, start_pos):
        raise NotImplementedError()


class FaceMaxMovementPolicy(BaseMovementPolicy):
    """FIFO of face-maximum candidates with delta-grid deduplication."""

    def __init__(self, canvas, deltas=(4, 8, 8), score_threshold=0.9):
        self.done_rounded_coords = set()
        self.score_threshold = score_threshold
        self._start_pos = None
        super().__init__(canvas, deque([]), deltas)

    def reset_state(self, start_pos):
        self.scored_coords = deque([])
        self.done_rounded_coords = set()
        self._start_pos = start_pos

    def get_state(self):
        return [(self.scored_coords, self.done_rounded_coords,
                 self._start_pos)]

    def restore_state(self, state):
        (self.scored_coords, self.done_rounded_coords,
         self._start_pos) = state[0]
        self.scored_coords = deque(self.scored_coords)
        self.done_rounded_coords = set(self.done_rounded_coords)

    def __next__(self):
        """Pops until a valid position is found; StopIteration when empty."""
        while self.scored_coords:
            _, coord = self.scored_coords.popleft()
            coord = tuple(coord)
            if self.quantize_pos(coord) in self.done_rounded_coords:
                continue
            if self.canvas.is_valid_pos(coord):
                return coord
        raise StopIteration()

    def quantize_pos(self, pos):
        """Quantizes a position to the delta lattice centered on the segment
        origin (so all directions are treated symmetrically)."""
        rel_pos = np.array(pos) - self._start_pos
        coord = (rel_pos + self.deltas // 2) // np.maximum(self.deltas, 1)
        return tuple(coord)

    def update(self, prob_map, position):
        """Queues face-maximum moves computed from a full probability map."""
        scored = sorted(
            get_scored_move_offsets(self.deltas, prob_map,
                                    threshold=self.score_threshold),
            reverse=True)
        qpos = self.quantize_pos(position)
        self.done_rounded_coords.add(qpos)
        for score, rel_coord in scored:
            coord = [int(rel_coord[i] + position[i]) for i in range(3)]
            self.scored_coords.append((score, coord))


def get_policy_fn(settings, model_info):
    """Builds a movement-policy factory from InferenceSettings."""
    if settings.movement_policy_name:
        policy_class = globals().get(settings.movement_policy_name)
        if policy_class is None:
            policy_class = registry.import_symbol(
                settings.movement_policy_name,
                default_packages="ffn_tpu_torch.inference")
    else:
        policy_class = FaceMaxMovementPolicy

    kwargs = json.loads(settings.movement_policy_args) \
        if settings.movement_policy_args else {}
    if "deltas" not in kwargs:
        kwargs["deltas"] = list(model_info.deltas[::-1])  # xyz -> zyx
    if "score_threshold" not in kwargs:
        kwargs["score_threshold"] = float(
            logit(settings.inference_options.move_threshold))
    return lambda canvas: policy_class(canvas, **kwargs)


class MovementRestrictor:
    """Excludes masked voxels from segmentation and from seeding.

    mask: (z, y, x); positive values exclude voxels from segmentation.
    seed_mask: (z, y, x); positive values exclude seed placement.
    """

    def __init__(self, mask: Optional[np.ndarray] = None,
                 seed_mask: Optional[np.ndarray] = None):
        self.mask = mask
        self.seed_mask = seed_mask

    def is_valid_seed(self, pos) -> bool:
        return self.seed_mask is None or not self.seed_mask[pos]

    def is_valid_pos(self, pos) -> bool:
        return self.mask is None or not self.mask[pos]

    def dense_invalid_mask(self, shape_zyx) -> Optional[np.ndarray]:
        """is_valid_pos at every voxel of a (z, y, x) volume: a bool array
        (True = excluded), or None if nothing is restricted. The hop path
        folds it into its blocked volume (movement.py:213 of the JAX
        package, whose shift-mask part is not ported)."""
        if self.mask is None:
            return None
        return np.broadcast_to(self.mask.astype(bool),
                               tuple(shape_zyx)).copy()
