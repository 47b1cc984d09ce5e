"""Moving-FOV training examples for the host-loop trainer (numpy only): a
copy of ffn_tpu/training/examples.py (get_example :35, BatchExampleIter
:107, the policies fixed_offsets :181, fixed_offsets_window :201,
no_offsets :279, max_pred_offsets :286). Each batch slot walks its own
example; update_seeds writes the step's logits back before the next move.
"""

from __future__ import annotations

import collections
import itertools
from concurrent import futures

import numpy as np
from scipy import special

from ffn_tpu_torch.inference import movement
from ffn_tpu_torch.training import mask


def get_example(load_example, eval_tracker, info, get_offsets,
                seed_pad: float, seed_shape):
    """Yields (seed_view, image, label, weights) for consecutive FOV moves.

    The yielded seed is a VIEW aliasing the example's seed canvas; the
    trainer writes updated predictions into it between moves.
    """
    while True:
        full_patches, full_labels, loss_weights, coord, volname = \
            load_example()
        seed = special.logit(mask.make_seed(seed_shape, 1, pad=seed_pad))

        for off in get_offsets(info, seed, full_labels, eval_tracker):
            predicted = mask.crop_and_pad(seed, off,
                                          info.input_seed_size[::-1])
            patches = mask.crop_and_pad(full_patches, off,
                                        info.input_image_size[::-1])
            labels = mask.crop_and_pad(full_labels, off,
                                       info.pred_mask_size[::-1])
            weights = mask.crop_and_pad(loss_weights, off,
                                        info.pred_mask_size[::-1])
            assert predicted.base is seed
            yield predicted, patches, labels, weights

        eval_tracker.add_patch(full_labels, seed, loss_weights, coord,
                               volume_name=volname)


def _batch_gen(make_example_generator_fn, batch_size: int):
    """Zips batch_size independent example generators (thread pool)."""
    example_gens = [make_example_generator_fn() for _ in range(batch_size)]
    with futures.ThreadPoolExecutor(max_workers=batch_size) as tpe:
        while True:
            fs = [tpe.submit(next, gen) for gen in example_gens]
            batch = [f.result() for f in fs]
            yield tuple(zip(*batch))


class BatchExampleIter:
    """Batches examples from independent generators; each batch slot
    advances through its own example's moves at its own pace."""

    def __init__(self, example_generator_fn, eval_tracker, batch_size: int,
                 info):
        self._eval_tracker = eval_tracker
        self._batch_generator = _batch_gen(example_generator_fn, batch_size)
        self._seeds = None
        self._info = info

    def __iter__(self):
        return self

    def __next__(self):
        seeds, patches, labels, weights = next(self._batch_generator)
        self._seeds = seeds
        batched_weights = np.concatenate(weights)
        self._eval_tracker.track_weights(batched_weights)
        return (np.concatenate(seeds), np.concatenate(patches),
                np.concatenate(labels), batched_weights)

    def update_seeds(self, batched_seeds):
        """Writes model outputs back into the per-example seed canvases."""
        assert self._seeds is not None
        batched_seeds = np.asarray(batched_seeds)

        dx = self._info.input_seed_size[0] - self._info.pred_mask_size[0]
        dy = self._info.input_seed_size[1] - self._info.pred_mask_size[1]
        dz = self._info.input_seed_size[2] - self._info.pred_mask_size[2]

        if dz == 0 and dy == 0 and dx == 0:
            for i, s in enumerate(self._seeds):
                s[:] = batched_seeds[i, ...]
        else:
            for i, s in enumerate(self._seeds):
                s[:, dz // 2:-(dz - dz // 2), dy // 2:-(dy - dy // 2),
                  dx // 2:-(dx - dx // 2), :] = batched_seeds[i, ...]


def _eval_move(seed, labels, off_xyz, seed_threshold, label_threshold):
    """(valid, wanted) for a move: seed/label values at the shifted center."""
    valid_move = seed[:, seed.shape[1] // 2 + off_xyz[2],
                      seed.shape[2] // 2 + off_xyz[1],
                      seed.shape[3] // 2 + off_xyz[0], 0] >= seed_threshold
    wanted_move = labels[:, labels.shape[1] // 2 + off_xyz[2],
                         labels.shape[2] // 2 + off_xyz[1],
                         labels.shape[3] // 2 + off_xyz[0],
                         0] >= label_threshold
    return valid_move, wanted_move


def fixed_offsets(info, seed, labels, eval_tracker, threshold,
                  fov_shifts=None):
    """Center followed by the fixed shift list, each gated on the seed."""
    label_threshold = special.expit(threshold)
    for off in itertools.chain([(0, 0, 0)], fov_shifts):  # xyz
        valid_move, wanted_move = _eval_move(seed, labels, off, threshold,
                                             label_threshold)
        eval_tracker.record_move(wanted_move, valid_move, off)
        if not valid_move:
            continue
        yield off


def _delta_shell(shape_zyx, deltas_xyz) -> np.ndarray:
    """Boolean zyx mask of the delta-lattice shell around the canvas
    center: voxels within the delta box that lie on at least one of its
    faces (the positions a single FOV move can land on)."""
    dists = [np.abs(np.arange(n) - n // 2)
             for n in shape_zyx]                       # per-axis |offset|
    d_zyx = deltas_xyz[::-1]
    within = np.ones(tuple(shape_zyx), bool)
    on_face = np.zeros(tuple(shape_zyx), bool)
    for axis, (dist, delta) in enumerate(zip(dists, d_zyx)):
        shape = [1, 1, 1]
        shape[axis] = -1
        within &= (dist <= delta).reshape(shape)
        on_face |= (dist == delta).reshape(shape)
    return within & on_face


def fixed_offsets_window(info, seed, labels, eval_tracker, threshold,
                         fov_shifts=None, radius: int = 4):
    """fixed_offsets but accepting any above-threshold voxel within a
    window on the delta shell orthogonal to the move direction."""
    label_threshold = special.expit(threshold)
    center_off = (0, 0, 0)
    valid_move, wanted_move = _eval_move(seed, labels, center_off,
                                         threshold, label_threshold)
    eval_tracker.record_move(wanted_move, valid_move, center_off)
    if valid_move:
        yield center_off

    shell = _delta_shell(seed.shape[1:4], info.deltas)
    seed_center = np.array(seed.shape[1:4]) // 2
    label_shift = np.array(labels.shape[1:4]) // 2 - seed_center

    def window_hits(volume, points_zyx, shift, level):
        """Any volume value >= level at the given (shifted) points?"""
        z, y, x = (points_zyx + shift.reshape(3, 1)) if shift.any() \
            else points_zyx
        return bool(np.any(volume[:, z, y, x, :] >= level))

    no_shift = np.zeros(3, np.int64)
    for off in fov_shifts:  # xyz
        # Window: the +/-radius box around the shifted center, intersected
        # with the delta shell.
        lo = seed_center + off[::-1] - radius
        hi = lo + 2 * radius + 1
        win = shell[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        points = np.stack(np.nonzero(win)) + lo.reshape(3, 1)

        valid_move = window_hits(seed, points, no_shift, threshold)
        wanted_move = window_hits(labels, points, label_shift,
                                  label_threshold)
        eval_tracker.record_move(wanted_move, valid_move, off)
        if valid_move:
            yield off


def no_offsets(info, seed, labels, eval_tracker):
    del info, labels, seed
    eval_tracker.record_move(True, True, (0, 0, 0))
    yield (0, 0, 0)


def max_pred_offsets(info, seed, labels, eval_tracker, threshold,
                     max_radius):
    """Inference-style BFS moves over the training canvas."""
    queue = collections.deque([(0, 0, 0)])  # xyz
    done = set()
    label_threshold = special.expit(threshold)
    deltas = np.array(info.deltas)

    while queue:
        offset = np.array(queue.popleft())
        if np.any(np.abs(np.array(offset)) > max_radius):
            continue
        quantized_offset = tuple((offset + deltas / 2)
                                 // np.maximum(deltas, 1))
        if quantized_offset in done:
            continue

        valid, wanted = _eval_move(seed, labels, tuple(offset), threshold,
                                   label_threshold)
        eval_tracker.record_move(wanted, valid, (0, 0, 0))
        if not valid or (not wanted and quantized_offset != (0, 0, 0)):
            continue
        done.add(quantized_offset)
        yield tuple(offset)

        curr_seed = mask.crop_and_pad(seed, offset,
                                      info.pred_mask_size[::-1])
        todos = sorted(
            movement.get_scored_move_offsets(
                info.deltas[::-1], curr_seed[0, ..., 0],
                threshold=threshold),
            reverse=True)
        queue.extend((x[2] + offset[0], x[1] + offset[1], x[0] + offset[2])
                     for _, x in todos)
