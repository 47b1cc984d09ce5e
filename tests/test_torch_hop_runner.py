"""ffn_tpu_torch's Runner and CLI on the batched hop path: concurrent_requests
4 with device finalization on test_torch_runner.py's 48^3 phantom and the
CI checkpoint; every decision agrees with the JAX package's, so
segmentations (ids included), origins and counters are identical. Host
finalization at 4 and 64 lanes: test_torch_hop_runner_jax.py (split so
test workers share the load).
"""

import os

import numpy as np
import pytest
import torch

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu_torch.inference import runner
from test_torch_imports import assert_imports_alone
from test_torch_runner import PAD, SIZE, _request

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

HOP_MODULES = [
    "ffn_tpu_torch.ops.hop",
    "ffn_tpu_torch.ops.lane",
    "ffn_tpu_torch.inference.hop_engine",
    "ffn_tpu_torch.inference.batch_canvas",
    "ffn_tpu_torch.inference.hop_canvas",
    "ffn_tpu_torch.inference.runner",
]


def _counts(counters):
    return {name: c.value for name, c in counters if not name.endswith("-ms")}


def test_devfin_runner_matches_jax_runner(tmp_path, monkeypatch):
    """FFN_TPU_DEVFIN=1: both Runners finalize in kernel (K8's plain version
    here), with the same segmentation, ids, origins and counters."""
    monkeypatch.setenv("FFN_TPU_DEVFIN", "1")
    box = (SIZE + 2 * PAD,) * 3
    request, _ = _request(tmp_path, tmp_path / "jax")
    request.concurrent_requests = 4
    want = jax_runner.Runner()
    want.start(request)
    want_canvas = want.run((0, 0, 0), box, keep_probability_maps=False)
    request.segmentation_output_dir = str(tmp_path / "torch")
    got = runner.Runner(device="cpu")
    got.start(request)
    got_canvas = got.run((0, 0, 0), box, keep_probability_maps=False)
    assert got_canvas.device_finalize and want_canvas.device_finalize
    np.testing.assert_array_equal(got_canvas.segmentation,
                                  want_canvas.segmentation)
    assert {k: (tuple(v.start_zyx), v.iters)
            for k, v in got_canvas.origins.items()} == \
        {k: (tuple(v.start_zyx), v.iters)
         for k, v in want_canvas.origins.items()}
    assert _counts(got.counters) == _counts(want.counters)
    assert len(got_canvas.origins) >= 2


def test_cli_runs_a_batched_request_on_the_cpu(tmp_path):
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
concurrent_requests: 4
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
    assert seg.shape == (36, 36, 36) and len(origins) == 2
    assert set(np.unique(seg[seg > 0])) == set(origins)
    assert os.path.exists(storage.object_prob_path(str(out), (0, 0, 0)))


@pytest.mark.parametrize("path,lanes,env,canvas_defaults", [
    ("serial", 1, {}, {}),
    ("hops 0", 4, {}, {"hops": 0}),
    ("device finalization", 4, {"FFN_TPU_DEVFIN": "1"}, {}),
    ("fused driver", 4, {}, {})])
def test_runner_refuses_what_it_does_not_run(tmp_path, monkeypatch, path,
                                             lanes, env, canvas_defaults):
    # bfloat16 seeds (FFN_TPU_SEED_DTYPE=bf16) on the paths through K2/K3,
    # K13/K14 and K8, which refused them until they took bf16 seeds: both
    # Runners with the CI checkpoint on the 32^3 phantom padded to 48^3,
    # the fused driver with one task and host finalization. The port's
    # float32 logits differ from flax's in the last digits, which can move
    # a rounded seed by one bf16 step. Measured on the CPU: the same
    # segmentation, ids and origins on all four paths and the same
    # counters, but for skip_invalid_pos on the serial and hops-0 paths
    # (243 in JAX, 244 here: one move on a seed that rounds across the
    # move threshold; with the JAX model's own logits in the port's Runner
    # every counter is equal). The tolerance: equal, skip_invalid_pos
    # within 1. What stays refused is float16 seeds, which the JAX Runner
    # never picks.
    monkeypatch.setenv("FFN_TPU_SEED_DTYPE", "bf16")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    size = 32
    box = (size + 2 * PAD,) * 3
    request, _ = _request(tmp_path, tmp_path / "jax", size=size)
    request.concurrent_requests = lanes
    runs = []
    for side, r in (("jax", jax_runner.Runner()),
                    ("torch", runner.Runner(device="cpu"))):
        request.segmentation_output_dir = str(tmp_path / side)
        r.canvas_defaults.update(canvas_defaults)
        r.start(request)
        if path == "fused driver":
            from ffn_tpu.parallel import multi_canvas as jax_multi_canvas
            from ffn_tpu_torch.parallel import multi_canvas
            from test_torch_multi_canvas import synchronous_jax_pools
            mc = jax_multi_canvas if side == "jax" else multi_canvas
            with synchronous_jax_pools():
                assert mc.MultiSubvolumeHopDriver(
                    r, [((0, 0, 0), box)], lanes=lanes,
                    device_finalize=False).run() == 1
            seg, origins = jax_storage.load_segmentation(
                str(tmp_path / side), (0, 0, 0), split_cc=False)
            origins = {k: (tuple(v.start_zyx), v.iters)
                       for k, v in origins.items()}
        else:
            cv = r.run((0, 0, 0), box, keep_probability_maps=False)
            seg = cv.segmentation
            origins = {k: (tuple(v.start_zyx), v.iters)
                       for k, v in cv.origins.items()}
            if path.startswith("device"):
                assert cv.device_finalize
        runs.append((seg, origins, _counts(r.counters), r))
    (wseg, worigins, wcounts, want), (seg, origins, counts, got) = runs
    assert got.engine.seed_dtype == torch.bfloat16
    assert want.engine.seed_dtype == np.dtype("bfloat16")
    np.testing.assert_array_equal(seg, wseg)
    assert origins == worigins and len(origins) >= 2
    assert abs(counts.pop("skip_invalid_pos", 0)
               - wcounts.pop("skip_invalid_pos", 0)) <= 1
    assert counts == wcounts and counts
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        type(got.engine)(got.model, pad_value=0.0, move_threshold=0.0,
                         disco_seed_threshold=0.0, device="cpu",
                         seed_dtype=torch.float16)


def test_hop_runner_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    request, _ = _request(tmp_path, tmp_path / "out")
    request.concurrent_requests = 64
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner(device="cuda").start(request)


def test_hop_modules_import_without_jax():
    assert_imports_alone(HOP_MODULES)
