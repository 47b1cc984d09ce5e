"""Inference request settings without protobuf: the InferenceRequest and
InferenceOptions fields the paths read; `from_proto` and `to_proto`
convert (only `to_proto` imports protobuf). Floats round to float32 as
the protos store them, so hand-built settings decide thresholds as parsed
ones do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _f32(value) -> float:
    return float(np.float32(value))


@dataclasses.dataclass
class InferenceOptions:
    """Probability-space inference options (InferenceOptions proto)."""

    init_activation: float = 0.0
    pad_value: float = 0.0
    move_threshold: float = 0.0
    segment_threshold: float = 0.0
    min_segment_size: int = 0
    # Unset in a request means 0.0, which enables the disco-seed mask.
    disco_seed_threshold: float = 0.0
    min_boundary_dist: Tuple[int, int, int] = (0, 0, 0)  # zyx

    def __post_init__(self):
        for name in ("init_activation", "pad_value", "move_threshold",
                     "segment_threshold", "disco_seed_threshold"):
            setattr(self, name, _f32(getattr(self, name)))
        self.min_segment_size = int(self.min_segment_size)
        self.min_boundary_dist = tuple(int(v) for v in self.min_boundary_dist)


# Request fields that the serial port does not implement yet
# (ROADMAP.md, Queue 1): a request that sets any of them is refused.
_UNSUPPORTED_REPEATED = ("masks", "seed_masks", "histogram_masks")
_UNSUPPORTED_OPTIONAL = ("shift_mask", "init_segmentation",
                         "reference_histogram", "self_prediction")


@dataclasses.dataclass
class InferenceSettings:
    """The InferenceRequest fields of one serial inference run.

    `image` is "<file.h5>:<dataset>" (an hdf5 volume) or "<file>.npy".
    """

    image: str
    model_name: str
    segmentation_output_dir: str
    inference_options: InferenceOptions = dataclasses.field(
        default_factory=InferenceOptions)
    image_mean: float = 0.0
    image_stddev: float = 1.0
    model_args: str = ""
    model_checkpoint_path: str = ""
    seed_policy: str = "PolicyPeaks"
    seed_policy_args: str = ""
    movement_policy_name: str = ""
    movement_policy_args: str = ""
    checkpoint_interval: int = 0
    concurrent_requests: int = 1

    def __post_init__(self):
        self.image_mean = _f32(self.image_mean)
        self.image_stddev = _f32(self.image_stddev)

    def to_proto(self, base=None):
        """This request as an InferenceRequest proto: a copy of `base` (the
        proto these settings came from, or an empty request) with each field
        these settings hold written where its value differs, so that a
        request passed through unchanged serializes to its own bytes."""
        from ffn_tpu_torch.proto import inference_pb2   # needs protobuf
        request = inference_pb2.InferenceRequest()
        if base is not None:
            request.CopyFrom(base)

        def put(msg, name, value):
            if getattr(msg, name) != value:
                setattr(msg, name, value)

        if request.image.hdf5 != self.image:
            request.image.hdf5 = self.image
        for name in ("model_name", "segmentation_output_dir", "image_mean",
                     "image_stddev", "model_args", "model_checkpoint_path",
                     "seed_policy", "seed_policy_args",
                     "movement_policy_name", "movement_policy_args",
                     "checkpoint_interval", "concurrent_requests"):
            put(request, name, getattr(self, name))
        opts = self.inference_options
        for name in ("init_activation", "pad_value", "move_threshold",
                     "segment_threshold", "min_segment_size",
                     "disco_seed_threshold"):
            put(request.inference_options, name, getattr(opts, name))
        mbd = request.inference_options.min_boundary_dist
        for name, value in zip("zyx", opts.min_boundary_dist):
            put(mbd, name, value)
        return request

    @classmethod
    def from_proto(cls, request) -> "InferenceSettings":
        """Converts a parsed InferenceRequest proto."""
        unsupported = [n for n in _UNSUPPORTED_REPEATED
                       if len(getattr(request, n))]
        unsupported += [n for n in _UNSUPPORTED_OPTIONAL
                        if request.HasField(n)]
        align = request.alignment_options
        if align.type not in (0, 1) or align.save_raw:  # UNKNOWN, NO_ALIGNMENT
            unsupported.append("alignment_options")
        if unsupported:
            raise NotImplementedError(
                f"InferenceRequest fields {unsupported} are not ported to "
                f"ffn_tpu_torch yet (ROADMAP.md, Queue 1)")
        which = request.image.WhichOneof("volume_path")
        if which != "hdf5":
            raise NotImplementedError(
                f"image volume {which!r}: ffn_tpu_torch opens hdf5 and .npy "
                f"volumes only")
        opts = request.inference_options
        mbd = opts.min_boundary_dist
        return cls(
            image=request.image.hdf5,
            model_name=request.model_name,
            segmentation_output_dir=request.segmentation_output_dir,
            inference_options=InferenceOptions(
                init_activation=opts.init_activation,
                pad_value=opts.pad_value,
                move_threshold=opts.move_threshold,
                segment_threshold=opts.segment_threshold,
                min_segment_size=opts.min_segment_size,
                disco_seed_threshold=opts.disco_seed_threshold,
                min_boundary_dist=(mbd.z, mbd.y, mbd.x)),
            image_mean=request.image_mean,
            image_stddev=request.image_stddev,
            model_args=request.model_args,
            model_checkpoint_path=request.model_checkpoint_path,
            seed_policy=request.seed_policy,
            seed_policy_args=request.seed_policy_args,
            movement_policy_name=request.movement_policy_name,
            movement_policy_args=request.movement_policy_args,
            checkpoint_interval=request.checkpoint_interval,
            concurrent_requests=request.concurrent_requests)
