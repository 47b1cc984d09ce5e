"""ffn_tpu_torch's round-based BatchCanvas (hops 0) against the JAX
package's: the cases of tests/test_batch_canvas{,_resume}.py through both
packages with the rule-based oracle (every round exact): segmentations,
origins and count counters identical; one lane equals the serial Canvas;
a killed run resumes; checkpoints restore across the packages and into
HopBatchCanvas; the Runner and the CLI take hops 0 and equal the JAX
Runner (CI checkpoint and oracle).
"""

import functools

import h5py
import numpy as np
import pytest
import torch

from ffn_tpu.inference import batch_canvas as jax_batch_canvas
from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu_torch.inference import batch_canvas, runner
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_canvas_e2e import make_image, make_options
from test_torch_canvas import GridSeeds, _port_canvas
from test_torch_hop_canvas import (_counts, _jax_engine, _origins,
                                   _port_engine, _port_options, make_port)
from test_torch_runner import PAD, SIZE, _request

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def make_jax_round(lanes, **kwargs):
    model, eng = _jax_engine(4096)
    return jax_batch_canvas.BatchCanvas(model.info, eng, make_image(),
                                        make_options(), lanes=lanes,
                                        candidates_per_step=4, **kwargs)


def make_port_round(lanes, **kwargs):
    model, eng = _port_engine(4096)
    return batch_canvas.BatchCanvas(model.info, eng, make_image(),
                                    _port_options(), lanes=lanes,
                                    candidates_per_step=4, **kwargs)


def _run(canvas, policy):
    canvas.segment_all(seed_policy=policy)
    return canvas


def assert_same_run(got, want):
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want)
    assert _counts(got) == _counts(want)


@functools.lru_cache(maxsize=None)
def _port_run(lanes):
    """The port's uninterrupted run at `lanes` (shared, not to be changed)."""
    return _run(make_port_round(lanes), GridSeeds)


@functools.lru_cache(maxsize=None)
def _serial():
    cv = _port_canvas(make_image())
    cv.segment_all(seed_policy=GridSeeds)
    return cv.segmentation, _origins(cv)


@pytest.mark.parametrize("lanes", [1, 2, 4, 12])
def test_round_canvas_matches_jax(lanes):
    want = _run(make_jax_round(lanes), JaxGridSeeds)
    got = _port_run(lanes)
    assert_same_run(got, want)
    assert len(got.origins) >= 2
    assert got.counters["fov-moves"].value > 0
    seg, origins = _serial()
    if lanes == 1:   # the serial Canvas, ids and iterations included
        np.testing.assert_array_equal(got.segmentation, seg)
        assert _origins(got) == origins
    if lanes == 2:   # origins and overlaps
        for sid, info in got.origins.items():
            assert got.segmentation[tuple(info.start_zyx)] == sid
            assert info.iters > 0
        assert set(got.overlaps) == set(got.origins)
    if lanes == 4:   # separated objects: the serial run's objects
        a, b = np.maximum(got.segmentation, 0), np.maximum(seg, 0)
        assert len(np.unique(a[a > 0])) == len(np.unique(b[b > 0]))
        np.testing.assert_array_equal(a > 0, b > 0)
    if lanes == 12:  # more lanes than objects: duplicate floods dropped
        assert got.counters["seed-claimed-drops"].value > 0


class _Die(Exception):
    pass


def _interrupted(canvas, policy, cpoint, die_after):
    """Runs `canvas` with a checkpoint every round until its die_after-th
    save; returns the start positions of the lanes then in flight."""
    canvas.checkpoint_path = cpoint
    canvas.checkpoint_interval_sec = 1e-9
    saves = {"n": 0}
    save = canvas.save_checkpoint

    def save_and_maybe_die(path):
        save(path)
        saves["n"] += 1
        if saves["n"] >= die_after:
            raise _Die()

    canvas.save_checkpoint = save_and_maybe_die
    with pytest.raises(_Die):
        canvas.segment_all(seed_policy=policy)
    return {li: tuple(int(v) for v in lane.start_pos)
            for li, lane in enumerate(canvas._lanes)
            if lane.state == batch_canvas._RUNNING and lane.num_iters}


_MAKERS = {"jax": (make_jax_round, JaxGridSeeds),
           "torch": (make_port_round, GridSeeds)}


@pytest.mark.parametrize("writer,reader", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_kill_and_resume_across_packages(tmp_path, writer, reader):
    cpoint = str(tmp_path / "cpoint.npz")
    make, policy = _MAKERS[writer]
    in_flight = _interrupted(make(4), policy, cpoint, die_after=4)
    assert in_flight

    make, policy = _MAKERS[reader]
    resumed = make(4)
    assert resumed.restore_checkpoint(cpoint) == 0
    assert {li for li, lane in enumerate(resumed._lanes)
            if lane.state == batch_canvas._RUNNING} == set(in_flight)
    _run(resumed, policy)
    uninterrupted = _port_run(4)   # the JAX package's too
    np.testing.assert_array_equal(np.maximum(resumed.segmentation, 0),
                                  np.maximum(uninterrupted.segmentation, 0))
    assert sorted(o.iters for o in resumed.origins.values()) == \
        sorted(o.iters for o in uninterrupted.origins.values())


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_round_checkpoint_restores_into_hop_canvas(tmp_path, writer):
    cpoint = str(tmp_path / "cpoint.npz")
    make, policy = _MAKERS[writer]
    in_flight = _interrupted(make(4), policy, cpoint, die_after=6)
    assert max(in_flight) >= 2, in_flight   # a lane the hop canvas lacks

    model, eng = _jax_engine(4096)
    want = jax_hop_canvas.HopBatchCanvas(model.info, eng, make_image(),
                                         make_options(), lanes=2, hops=3)
    want.restore_checkpoint(cpoint)
    got = make_port(2, 3)
    got.restore_checkpoint(cpoint)
    for li, pos in in_flight.items():
        if li >= 2:   # re-floods from its seed
            assert pos in got._deferred and pos in want._deferred
        else:
            assert got._lanes[li].state == batch_canvas._RUNNING
    assert np.array_equal(got._state.done.numpy(), np.asarray(
        want._state.done))
    _run(want, JaxGridSeeds)
    _run(got, GridSeeds)
    assert_same_run(got, want)
    assert len(got.origins) >= 2


def _values(counters):
    return {name: c.value for name, c in counters if not name.endswith("-ms")}


def _runner_pair(tmp_path, monkeypatch, via_env):
    """Both Runners with hops 0 at 4 lanes: through canvas_defaults on the
    48^3 phantom with the CI checkpoint, through FFN_TPU_HOPS=0 on
    test_canvas_e2e.py's volume with the oracle model."""
    request, _ = _request(tmp_path, tmp_path / "jax")
    request.concurrent_requests = 4
    box = (SIZE + 2 * PAD,) * 3
    runners = [jax_runner.Runner(), runner.Runner(device="cpu")]
    if via_env:
        monkeypatch.setenv("FFN_TPU_HOPS", "0")
        vol = str(tmp_path / "e2e.h5")
        with h5py.File(vol, "w") as f:
            f.create_dataset("raw", data=make_image())
        request.image.hdf5 = f"{vol}:raw"
        request.image_mean, request.image_stddev = 0, 1
        request.model_name = "oracle.ThresholdOracleModel"
        request.model_args = '{"fov_size": [9, 9, 9], "deltas": [2, 2, 2]}'
        request.model_checkpoint_path = ""
        request.inference_options.min_segment_size = 5
        box = make_image().shape
    else:
        for r in runners:
            r.canvas_defaults["hops"] = 0
    canvases = []
    for r, out in zip(runners, ("jax", "torch")):
        request.segmentation_output_dir = str(tmp_path / out)
        r.start(request)
        canvases.append(r.run((0, 0, 0), box, keep_probability_maps=False))
    return runners, canvases


@pytest.mark.parametrize("via_env", [False, True])
def test_round_runner_matches_jax_runner(tmp_path, monkeypatch, via_env):
    (want, got), (want_canvas, got_canvas) = _runner_pair(
        tmp_path, monkeypatch, via_env)
    assert len(got_canvas.origins) >= 2
    assert type(got_canvas) is batch_canvas.BatchCanvas
    assert type(want_canvas) is jax_batch_canvas.BatchCanvas
    assert got_canvas.K == want_canvas.K == 4
    np.testing.assert_array_equal(got_canvas.segmentation,
                                  want_canvas.segmentation)
    assert _origins(got_canvas) == _origins(want_canvas)
    assert _values(got.counters) == _values(want.counters)
    assert got.counters["fov-moves"].value > 0
    # The same seg-0_0_0.npz, through the JAX package's reader.
    for side in ("jax", "torch"):
        seg, _ = jax_storage.load_segmentation(str(tmp_path / side),
                                               (0, 0, 0), split_cc=False)
        np.testing.assert_array_equal(seg, np.maximum(
            want_canvas.segmentation, 0).astype(np.uint64))


def test_cli_runs_a_round_based_request_on_the_cpu(tmp_path, monkeypatch):
    from ffn_tpu_torch.cli import run_inference

    monkeypatch.setenv("FFN_TPU_HOPS", "0")
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
    made = []
    init = batch_canvas.BatchCanvas.__init__

    def record(self, *args, **kwargs):
        made.append(type(self))
        init(self, *args, **kwargs)

    monkeypatch.setattr(batch_canvas.BatchCanvas, "__init__", record)
    run_inference.main([
        f"--inference_request={request}",
        "--bounding_box=start { x:0 y:0 z:0 } size { x:36 y:36 z:36 }",
        "--device=cpu"])
    assert made == [batch_canvas.BatchCanvas]
    seg, origins = jax_storage.load_segmentation(str(out), (0, 0, 0),
                                                 split_cc=False)
    assert seg.shape == (36, 36, 36) and len(origins) == 2
    assert set(np.unique(seg[seg > 0])) == set(origins)


def test_round_runner_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("FFN_TPU_HOPS", "0")
    request, _ = _request(tmp_path, tmp_path / "out")
    request.concurrent_requests = 4
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner(device="cuda").start(request)
