"""Training eval metrics tracker (numpy): the reference's EvalTracker
definitions (ffn/training/tracker.py:63-440): FOV-move accuracy in total
and per move radius, patch loss, voxel confusion counts with
precision/recall/F1/specificity/accuracy, and ortho-slice images, as a
numpy redesign (the reference's file is TF1-coupled and does not compile).
"""

from __future__ import annotations

import collections
import io
from typing import Optional, Sequence

import numpy as np
from scipy.special import expit, logit


class MoveStats:
    __slots__ = ("correct", "missed", "spurious", "total")

    def __init__(self):
        self.correct = 0
        self.missed = 0
        self.spurious = 0
        self.total = 0


class EvalTracker:
    """Tracks eval metrics of the moving-FOV training process."""

    def __init__(self, eval_shape_zyx: Sequence[int],
                 shifts_xyz: Optional[Sequence] = None,
                 image_summaries: bool = False):
        self.eval_shape = tuple(eval_shape_zyx)
        self._image_summaries = image_summaries
        self.reset()
        self._radii = sorted({int(np.linalg.norm(s))
                              for s in (shifts_xyz or [])})

    def reset(self):
        self.eval_labels = np.zeros(self.eval_shape, np.float32)
        self.eval_preds = np.zeros(self.eval_shape, np.float32)
        self.eval_threshold = logit(0.9)
        self.moves = MoveStats()
        self.moves_by_radius = collections.defaultdict(MoveStats)
        self.loss_sum = 0.0
        self.loss_count = 0
        self.tp = self.fp = self.tn = self.fn = 0
        self.num_patches = 0
        self.masked_voxel_fraction_sum = 0.0
        self.weights_count = 0
        self.images_xy = collections.deque(maxlen=16)
        self.images_xz = collections.deque(maxlen=16)
        self.images_yz = collections.deque(maxlen=16)

    # -- move accuracy -------------------------------------------------------

    def record_move(self, wanted: bool, valid: bool, offset_xyz):
        """Records one FOV move decision.

        wanted: ground truth says the move should happen;
        valid: the model's seed admitted the move.
        """
        wanted = bool(np.any(wanted))
        valid = bool(np.any(valid))
        radius = int(np.linalg.norm(offset_xyz))
        for stats in (self.moves, self.moves_by_radius[radius]):
            stats.total += 1
            if wanted and valid:
                stats.correct += 1
            elif wanted and not valid:
                stats.missed += 1
            elif valid and not wanted:
                stats.spurious += 1

    def track_weights(self, weights: np.ndarray):
        self.masked_voxel_fraction_sum += float((weights == 0).mean())
        self.weights_count += 1

    # -- patch metrics ---------------------------------------------------------

    def add_patch(self, labels: np.ndarray, predicted_logits: np.ndarray,
                  weights: np.ndarray, coord=None, volume_name=None):
        """Records loss/confusion for a finished training example.

        Args:
          labels: (b, z, y, x, 1) soft labels (probabilities)
          predicted_logits: (b, z, y, x, 1) seed canvas in logit space
          weights: (b, z, y, x, 1) loss weights
        """
        lab = self._center_crop(np.asarray(labels))
        logits = self._center_crop(np.asarray(predicted_logits))
        w = self._center_crop(np.asarray(weights))

        # Sigmoid cross entropy, stable form.
        x = logits
        z = lab
        loss = np.maximum(x, 0) - x * z + np.log1p(np.exp(-np.abs(x)))
        loss = loss * w
        self.loss_sum += float(loss.mean())
        self.loss_count += 1

        pred_pos = expit(x) > 0.5
        true_pos = z > 0.5
        self.tp += int(np.sum(pred_pos & true_pos))
        self.fp += int(np.sum(pred_pos & ~true_pos))
        self.fn += int(np.sum(~pred_pos & true_pos))
        self.tn += int(np.sum(~pred_pos & ~true_pos))
        self.num_patches += 1

        if self._image_summaries:
            self._record_slices(lab, x, w, coord)

    def _center_crop(self, arr: np.ndarray) -> np.ndarray:
        spatial = np.array(arr.shape[1:-1])
        target = np.array(self.eval_shape)
        start = spatial // 2 - target // 2
        sel = tuple([slice(None)]
                    + [slice(s, s + t) for s, t in zip(start, target)]
                    + [slice(None)])
        return arr[sel]

    def _record_slices(self, labels, logits, weights, coord):
        z, y, x = np.array(labels.shape[1:4]) // 2
        for axis, images in ((1, self.images_xy), (2, self.images_xz),
                             (3, self.images_yz)):
            sel = [slice(0, 1), slice(None), slice(None), slice(None),
                   slice(0, 1)]
            sel[axis] = slice([z, y, x][axis - 1], [z, y, x][axis - 1] + 1)
            lab2d = np.squeeze(labels[tuple(sel)])
            pred2d = expit(np.squeeze(logits[tuple(sel)]))
            w2d = np.squeeze(weights[tuple(sel)])
            side_by_side = np.concatenate(
                [lab2d, pred2d, w2d], axis=1)
            images.append((coord, side_by_side))

    def slice_image_pngs(self):
        """Renders the recorded label|prediction|weights slice panels as
        PNG byte strings (the reference's tracker image summaries,
        tracker.py:169-257), tagged final_xy/final_xz/final_yz."""
        from PIL import Image
        import io

        out = {}
        for tag, images in (("final_xy", self.images_xy),
                            ("final_xz", self.images_xz),
                            ("final_yz", self.images_yz)):
            rendered = []
            for coord, panel in images:
                arr = np.clip(panel * 255.0, 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="png")
                rendered.append((coord, buf.getvalue()))
            out[tag] = rendered
        return out

    # -- summaries -------------------------------------------------------------

    def get_summaries(self) -> dict:
        """Returns {name: value} metrics, reference-compatible names."""
        def rate(n, d):
            return n / max(d, 1)

        precision = rate(self.tp, self.tp + self.fp)
        recall = rate(self.tp, self.tp + self.fn)
        out = {
            "eval/patch_loss": rate(self.loss_sum, self.loss_count),
            "eval/patches": self.num_patches,
            "eval/accuracy": rate(self.tp + self.tn,
                                  self.tp + self.tn + self.fp + self.fn),
            "eval/precision": precision,
            "eval/recall": recall,
            "eval/specificity": rate(self.tn, self.tn + self.fp),
            "eval/f1": rate(2.0 * precision * recall,
                            precision + recall) if
            (precision + recall) > 0 else 0.0,
            "eval/masked_voxel_fraction": rate(
                self.masked_voxel_fraction_sum, self.weights_count),
            "moves/total": self.moves.total,
            "moves/correct": rate(self.moves.correct, self.moves.total),
            "moves/missed": rate(self.moves.missed, self.moves.total),
            "moves/spurious": rate(self.moves.spurious, self.moves.total),
        }
        for radius, stats in sorted(self.moves_by_radius.items()):
            prefix = f"moves_{radius}"
            out[f"{prefix}/correct"] = rate(stats.correct, stats.total)
            out[f"{prefix}/missed"] = rate(stats.missed, stats.total)
            out[f"{prefix}/spurious"] = rate(stats.spurious, stats.total)
        return out
