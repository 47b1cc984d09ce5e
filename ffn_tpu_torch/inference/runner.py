"""Inference run orchestration (ffn_tpu/inference/runner.py: Runner.start,
.run): concurrent_requests <= 1 builds the serial Canvas, more the
HopBatchCanvas (HopEngine.run_hops) or with hops 0 the round-based
BatchCanvas; settings or a parsed InferenceRequest; weights from the JAX
package's flat npz checkpoints; precision "int8" (or FFN_TPU_PRECISION=int8)
wraps the model in ops/quantized.py's QuantizedConvStack3DModel.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import logit

from ffn_tpu_torch.inference import align as align_lib
from ffn_tpu_torch.inference import batch_canvas as batch_canvas_lib
from ffn_tpu_torch.inference import canvas as canvas_lib
from ffn_tpu_torch.inference import engine as engine_lib
from ffn_tpu_torch.inference import hop_canvas as hop_canvas_lib
from ffn_tpu_torch.inference import hop_engine as hop_engine_lib
from ffn_tpu_torch.inference import movement
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.inference.counters import Counters, timer_counter
from ffn_tpu_torch.inference.settings import InferenceSettings
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.models import registry
from ffn_tpu_torch.ops import quantized

Tuple3i = Tuple[int, int, int]


def load_model_params(path: str) -> dict:
    """Loads model params from the JAX package's flat npz checkpoints."""
    if path.endswith(".npz") and os.path.exists(path):
        return params_io.load_params_npz(path)
    raise NotImplementedError(
        f"checkpoint {path!r}: ffn_tpu_torch loads flat .npz checkpoints "
        f"only; TF1 and orbax checkpoints are not ported (ROADMAP.md)")


class Runner:
    """Runs FFN inference over subvolumes of a dataset on one device."""

    def __init__(self, device="cuda"):
        self.device = engine_lib.resolve_device(device)
        self.counters = Counters()
        # Extra kwargs merged into every batched canvas (e.g. hops,
        # max_iters_per_segment).
        self.canvas_defaults = {}
        self.engine: Optional[hop_engine_lib.HopEngine] = None
        self.canvases = {}
        self._image_volume = None

    def start(self, request, precision: Optional[str] = None):
        """Opens the image volume and builds the model + engine.

        request: InferenceSettings or a parsed InferenceRequest proto.
        precision: None (the model's own) or "int8", the quantized stack
        (ops/quantized.py: K19, K20); None reads FFN_TPU_PRECISION. As in
        the JAX Runner, any other value runs the model's own precision.
        """
        # A saved segmentation carries the request as the proto it came in
        # as, with the settings changed since written over it.
        self._request_proto = None
        if not isinstance(request, InferenceSettings):
            self._request_proto = request
            request = InferenceSettings.from_proto(request)
        if precision is None:
            precision = os.environ.get("FFN_TPU_PRECISION") or None
        self.request = request
        os.makedirs(request.segmentation_output_dir, exist_ok=True)

        with timer_counter(self.counters, "init-model"):
            model_class = registry.import_symbol(request.model_name)
            model_args = json.loads(request.model_args) \
                if request.model_args else {}
            self.model = model_class(**model_args)
            self._model_info = self.model.info
        if getattr(self.model, "dtype", None) == torch.float16 and \
                precision != "int8":
            raise NotImplementedError(
                "float16 inference is not ported to ffn_tpu_torch "
                "(ROADMAP.md): no JAX bench or config runs it; float16 "
                "models train (--precision f16)")

        with timer_counter(self.counters, "load-params"):
            if request.model_checkpoint_path:
                self.model.load_params(
                    load_model_params(request.model_checkpoint_path))
            # Without a checkpoint the model keeps its random init
            # (oracle and smoke runs).
            if precision == "int8":
                self.model = quantized.QuantizedConvStack3DModel(self.model)
                self.model.prepare()
            self.model.to(self.device)

        opts = request.inference_options
        # HopEngine is a superset of FloodFillEngine: the serial Canvas
        # uses its step, HopBatchCanvas its hop programs (runner.py:126).
        seed_dtype = (torch.bfloat16
                      if os.environ.get("FFN_TPU_SEED_DTYPE") == "bf16"
                      else torch.float32)
        self.engine = hop_engine_lib.HopEngine(
            self.model,
            pad_value=float(logit(opts.pad_value)),
            move_threshold=float(logit(opts.move_threshold)),
            disco_seed_threshold=opts.disco_seed_threshold,
            device=self.device, seed_dtype=seed_dtype)

        self._image_volume = storage.decorated_volume(request.image)

    def load_subvolume_inputs(self, corner: Tuple3i, subvol_size: Tuple3i,
                              subvol_counters=None):
        """Fetches + normalizes one subvolume's image (identity alignment)."""
        if subvol_counters is None:
            subvol_counters = self.counters.get_sub_counters()
        with timer_counter(subvol_counters, "load-image"):
            logging.info("Process subvolume: %r", corner)
            alignment = align_lib.Alignment(corner, subvol_size)
            dst_corner, dst_size = alignment.expand_bounds(
                corner, subvol_size, forward=True)
            src_corner, src_size = alignment.expand_bounds(
                dst_corner, dst_size, forward=False)
            src_corner, src_size = storage.clip_subvolume_to_bounds(
                src_corner, src_size, self._image_volume)

            slc = tuple(slice(int(c), int(c + s))
                        for c, s in zip(src_corner, src_size))
            volume = self._image_volume
            src_image = volume[(0,) + slc] if volume.ndim == 4 \
                else volume[slc]
            image = alignment.align_and_crop(
                src_corner, np.asarray(src_image), dst_corner, dst_size,
                forward=True)
            logging.info("Image data loaded, shape: %r.", image.shape)

        image = ((image.astype(np.float32) - self.request.image_mean)
                 / self.request.image_stddev)
        return dict(image=image, alignment=alignment, dst_corner=dst_corner,
                    counters=subvol_counters)

    def make_canvas(self, corner: Tuple3i, subvol_size: Tuple3i,
                    **canvas_kwargs):
        """Builds the Canvas for a subvolume; returns (canvas, alignment).

        concurrent_requests > 1 builds HopBatchCanvas with that many lanes
        and `hops` from canvas_defaults, else FFN_TPU_HOPS, else 16; hops <=
        0 builds the round-based BatchCanvas (runner.py:278-311).
        """
        inputs = self.load_subvolume_inputs(corner, subvol_size)
        lanes = max(1, self.request.concurrent_requests)
        if lanes > 1:
            merged = {**self.canvas_defaults, **canvas_kwargs}
            hops = int(merged.pop("hops",
                                  os.environ.get("FFN_TPU_HOPS", "16")))
            common = dict(
                lanes=lanes, counters=inputs["counters"],
                corner_zyx=inputs["dst_corner"],
                checkpoint_path=storage.checkpoint_path(
                    self.request.segmentation_output_dir, corner),
                checkpoint_interval_sec=self.request.checkpoint_interval)
            if hops > 0:
                canvas = hop_canvas_lib.HopBatchCanvas(
                    self._model_info, self.engine, inputs["image"],
                    self.request.inference_options, hops=hops, **common,
                    **merged)
            else:
                canvas = batch_canvas_lib.BatchCanvas(
                    self._model_info, self.engine, inputs["image"],
                    self.request.inference_options, **common, **merged)
            return canvas, inputs["alignment"]
        canvas = canvas_lib.Canvas(
            self._model_info, self.engine, inputs["image"],
            self.request.inference_options,
            counters=inputs["counters"],
            movement_policy_fn=movement.get_policy_fn(
                self.request, self._model_info),
            checkpoint_path=storage.checkpoint_path(
                self.request.segmentation_output_dir, corner),
            checkpoint_interval_sec=self.request.checkpoint_interval,
            corner_zyx=inputs["dst_corner"],
            **canvas_kwargs)
        return canvas, inputs["alignment"]

    def get_seed_policy(self, corner, subvol_size):
        policy_cls = getattr(seed_lib, self.request.seed_policy)
        kwargs = {"corner": corner, "subvol_size": subvol_size}
        if self.request.seed_policy_args:
            kwargs.update(json.loads(self.request.seed_policy_args))
        return functools.partial(policy_cls, **kwargs)

    def save_segmentation(self, canvas, alignment, target_path, prob_path):
        """Saves the segmentation (+ quantized POM) of a finished canvas."""
        def unalign_image(im3d):
            return alignment.align_and_crop(
                canvas.corner_zyx, im3d, alignment.corner, alignment.size,
                forward=False)

        def unalign_origins(origins, canvas_corner):
            out = {}
            for key, value in origins.items():
                zyx = np.array(value.start_zyx) + canvas_corner
                zyx = alignment.transform(zyx[:, np.newaxis],
                                          forward=False).squeeze()
                zyx -= canvas_corner
                out[key] = value._replace(start_zyx=tuple(zyx))
            return out

        canvas.segmentation[canvas.segmentation < 0] = 0
        storage.save_subvolume(
            unalign_image(canvas.segmentation),
            unalign_origins(canvas.origins, np.array(canvas.corner_zyx)),
            target_path,
            request=self.request.to_proto(
                self._request_proto).SerializeToString(),
            counters=canvas.counters.dumps(),
            overlaps=canvas.overlaps)

        if canvas.seg_prob is not None:
            prob = unalign_image(canvas.seg_prob)
            with storage.atomic_file(prob_path) as fd:
                np.savez_compressed(fd, qprob=prob)

    def run(self, corner: Tuple3i, subvol_size: Tuple3i,
            reset_counters=True, keep_probability_maps=True):
        """Runs FFN inference over one subvolume (idempotent)."""
        if reset_counters:
            self.counters.reset()

        out_dir = self.request.segmentation_output_dir
        seg_path = storage.segmentation_path(out_dir, corner)
        prob_path = storage.object_prob_path(out_dir, corner)
        cpoint_path = storage.checkpoint_path(out_dir, corner)

        if os.path.exists(seg_path):
            return None

        canvas, alignment = self.make_canvas(
            corner, subvol_size,
            keep_probability_maps=keep_probability_maps)

        partial_segment_iters = 0
        if os.path.exists(cpoint_path):
            partial_segment_iters = canvas.restore_checkpoint(cpoint_path)

        self.canvases[tuple(corner)] = canvas
        canvas.segment_all(
            seed_policy=self.get_seed_policy(corner, subvol_size),
            partial_segment_iters=partial_segment_iters)
        self.save_segmentation(canvas, alignment, seg_path, prob_path)
        del self.canvases[tuple(corner)]

        try:
            os.remove(cpoint_path)
        except OSError:
            pass
        return canvas
