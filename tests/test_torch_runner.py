"""ffn_tpu_torch's serial Runner against the JAX package's on
test_ci_quality_floor.py's 48^3 phantom with the CI checkpoint, from the
same request: every decision agrees, so the segmentations are identical,
ids included (the logits differ in the last float32 digits).
"""

import os
import sys

import h5py
import numpy as np
import pytest
import torch
from google.protobuf import text_format

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.proto import inference_pb2
from ffn_tpu_torch.inference import runner
from ffn_tpu_torch.inference.settings import InferenceSettings
from test_torch_imports import assert_imports_alone

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import synthetic_em  # noqa: E402

CKPT = os.path.join(REPO, "models", "phantom", "model-ci-tiny.npz")
SIZE, PAD = 48, 8

# Every ffn_tpu_torch module on the serial path.
SLICE_MODULES = [
    "ffn_tpu_torch._build",
    "ffn_tpu_torch.ops.conv3d",
    "ffn_tpu_torch.ops.step",
    "ffn_tpu_torch.ops.image",
    "ffn_tpu_torch.models.params_io",
    "ffn_tpu_torch.models.convstack_3d",
    "ffn_tpu_torch.models.oracle",
    "ffn_tpu_torch.models.registry",
    "ffn_tpu_torch.inference.settings",
    "ffn_tpu_torch.inference.counters",
    "ffn_tpu_torch.inference.storage",
    "ffn_tpu_torch.inference.align",
    "ffn_tpu_torch.inference.movement",
    "ffn_tpu_torch.inference.seed",
    "ffn_tpu_torch.inference.engine",
    "ffn_tpu_torch.inference.canvas",
    "ffn_tpu_torch.inference.runner",
    "ffn_tpu_torch.cli.run_inference",
]


def _request(tmp_path, out, size=SIZE):
    image, gt = synthetic_em.make_volume(size=size, seed=3, num_cells=6)
    vol = str(tmp_path / "v.h5")
    with h5py.File(vol, "w") as f:
        f.create_dataset("raw", data=np.pad(image, PAD, mode="reflect"))
    request = inference_pb2.InferenceRequest()
    text_format.Parse(f"""
image {{ hdf5: "{vol}:raw" }}
image_mean: 128 image_stddev: 33
seed_policy: "PolicyPeaks"
model_checkpoint_path: "{CKPT}"
model_name: "convstack_3d.ConvStack3DFFNModel"
model_args: "{{\\"depth\\": 2, \\"fov_size\\": [17, 17, 17], \\"deltas\\": [6, 6, 6], \\"features\\": 16}}"
segmentation_output_dir: "{out}"
inference_options {{
  init_activation: 0.95 pad_value: 0.05 move_threshold: 0.9
  min_boundary_dist {{ x: 1 y: 1 z: 1 }}
  segment_threshold: 0.6 min_segment_size: 300
}}""", request)
    return request, gt


def test_runner_matches_jax_runner(tmp_path):
    box = (SIZE + 2 * PAD,) * 3
    request, gt = _request(tmp_path, tmp_path / "jax")
    want = jax_runner.Runner()
    want.start(request)
    want_canvas = want.run((0, 0, 0), box, keep_probability_maps=False)

    request.segmentation_output_dir = str(tmp_path / "torch")
    got = runner.Runner(device="cpu")
    got.start(request)  # the proto converts to InferenceSettings
    got_canvas = got.run((0, 0, 0), box, keep_probability_maps=False)

    np.testing.assert_array_equal(got_canvas.segmentation,
                                  want_canvas.segmentation)
    assert {k: (tuple(v.start_zyx), v.iters)
            for k, v in got_canvas.origins.items()} == \
        {k: (tuple(v.start_zyx), v.iters)
         for k, v in want_canvas.origins.items()}
    assert got.counters["update_at-calls"].value == \
        want.counters["update_at-calls"].value

    # The port's seg-0_0_0.npz loads through the JAX package's reader.
    seg, origins = jax_storage.load_segmentation(
        str(tmp_path / "torch"), (0, 0, 0), split_cc=False)
    np.testing.assert_array_equal(seg, np.maximum(
        got_canvas.segmentation, 0).astype(np.uint64))
    assert set(origins) == set(got_canvas.origins) and origins

    # And it segments the phantom: every cell found.
    inner = seg[PAD:-PAD, PAD:-PAD, PAD:-PAD]
    assert synthetic_em.object_level_agreement(
        gt.astype(np.uint64), inner, min_size=300) == 1.0


def test_settings_match_the_proto(tmp_path):
    request, _ = _request(tmp_path, tmp_path / "out")
    settings = InferenceSettings.from_proto(request)
    opts = settings.inference_options
    assert opts.disco_seed_threshold == 0.0  # unset: the mask is on
    assert opts.min_boundary_dist == (1, 1, 1)
    # Hand-built values round to float32 as the proto's fields do.
    assert opts.move_threshold == request.inference_options.move_threshold
    assert InferenceSettings(
        image="v.npy", model_name="m", segmentation_output_dir="o",
        image_mean=128.1).image_mean == np.float32(128.1)

    # concurrent_requests > 1 is the batched hop path (test_torch_hop_runner).
    request.concurrent_requests = 4
    assert InferenceSettings.from_proto(request).concurrent_requests == 4
    request.concurrent_requests = 1
    request.masks.add()
    with pytest.raises(NotImplementedError, match="masks"):
        InferenceSettings.from_proto(request)


def test_slice_imports_without_jax():
    assert_imports_alone(SLICE_MODULES)


def test_runner_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner()  # cuda is the default


def test_cli_runs_a_request_on_the_cpu(tmp_path):
    from ffn_tpu_torch.cli import run_inference
    from ffn_tpu_torch.inference import storage
    from test_canvas_e2e import make_image

    vol = str(tmp_path / "v.npy")
    np.save(vol, make_image())
    out = tmp_path / "out"
    request = f"""
image {{ hdf5: "{vol}" }}
image_mean: 0 image_stddev: 1
seed_policy: "PolicyPeaks"
model_name: "oracle.ThresholdOracleModel"
model_args: "{{\\"fov_size\\": [9, 9, 9], \\"deltas\\": [2, 2, 2]}}"
segmentation_output_dir: "{out}"
inference_options {{
  init_activation: 0.95 pad_value: 0.05 move_threshold: 0.9
  min_boundary_dist {{ x: 1 y: 1 z: 1 }}
  segment_threshold: 0.6 min_segment_size: 5
}}"""
    run_inference.main([
        f"--inference_request={request}",
        "--bounding_box=start { x:0 y:0 z:0 } size { x:36 y:36 z:36 }",
        "--device=cpu"])
    seg, origins = jax_storage.load_segmentation(str(out), (0, 0, 0),
                                                 split_cc=False)
    assert seg.shape == (36, 36, 36) and origins
    assert set(np.unique(seg[seg > 0])) == set(origins)
    assert os.path.exists(out / "counters.txt")
    assert os.path.exists(storage.object_prob_path(str(out), (0, 0, 0)))
