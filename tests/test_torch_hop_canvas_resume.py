"""ffn_tpu_torch's HopBatchCanvas against the serial Canvas and across a
kill: lanes=1 equals the serial Canvas; a killed run resumes to the
uninterrupted result (also into fewer lanes, the rest deferred), from
the JAX package's checkpoint and into its canvas.
"""

import numpy as np
import pytest
import torch

from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu_torch.inference import batch_canvas
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_canvas_e2e import make_image, make_options
from test_torch_canvas import GridSeeds, _port_canvas
from test_torch_hop_canvas import (_counts, _jax_engine, _origins, make_port,
                                   run_jax, run_port)

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def test_single_lane_hops_match_serial_canvas():
    hc = run_port(lanes=1, hops=8)
    cv = _port_canvas(make_image())
    cv.segment_all(seed_policy=GridSeeds)
    np.testing.assert_array_equal(hc.segmentation, cv.segmentation)
    assert _origins(hc) == _origins(cv)


class _Die(Exception):
    pass


def _interrupted(cpoint, lanes, hops, die_after):
    hc = make_port(lanes, hops, checkpoint_path=cpoint,
                   checkpoint_interval_sec=1e-9)
    saves = {"n": 0}
    save = hc.save_checkpoint

    def save_and_maybe_die(path):
        save(path)
        saves["n"] += 1
        if saves["n"] >= die_after:
            raise _Die()

    hc.save_checkpoint = save_and_maybe_die
    with pytest.raises(_Die):
        hc.segment_all(seed_policy=GridSeeds)
    return hc


@pytest.mark.parametrize("lanes,restore_lanes", [(4, 4), (4, 2)])
def test_kill_and_resume_reproduces_segmentation(tmp_path, lanes,
                                                 restore_lanes):
    cpoint = str(tmp_path / "cpoint.npz")
    uninterrupted = run_port(lanes=lanes, hops=3)
    hc = _interrupted(cpoint, lanes, 3, die_after=4)
    in_flight = [tuple(int(v) for v in lane.start_pos)
                 for lane in hc._lanes
                 if lane.state == batch_canvas._RUNNING and lane.num_iters]
    assert in_flight

    hc2 = make_port(restore_lanes, 3)
    assert hc2.restore_checkpoint(cpoint) == 0
    for pos in in_flight[restore_lanes:]:
        assert pos in hc2._deferred   # re-floods from its seed
    hc2.segment_all(seed_policy=GridSeeds)
    np.testing.assert_array_equal(np.maximum(hc2.segmentation, 0),
                                  np.maximum(uninterrupted.segmentation, 0))
    if restore_lanes == lanes:
        assert sorted(o.iters for o in hc2.origins.values()) == \
            sorted(o.iters for o in uninterrupted.origins.values())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hop_checkpoint_restores_across_packages(tmp_path, writer):
    """A hop-format checkpoint of either package resumes in the other to
    the uninterrupted result (the counters travel as a TaskCounters
    proto)."""
    def make_jax(lanes, hops, **kwargs):
        model, eng = _jax_engine(4096)
        return jax_hop_canvas.HopBatchCanvas(
            model.info, eng, make_image(), make_options(), lanes=lanes,
            hops=hops, **kwargs)

    cpoint = str(tmp_path / "cpoint.npz")
    make, policy = ((make_jax, JaxGridSeeds) if writer == "jax"
                    else (make_port, GridSeeds))
    hc = make(4, 3, checkpoint_path=cpoint, checkpoint_interval_sec=1e-9)
    saves = {"n": 0}
    save = hc.save_checkpoint

    def save_and_maybe_die(path):
        save(path)
        saves["n"] += 1
        if saves["n"] >= 4:
            raise _Die()

    hc.save_checkpoint = save_and_maybe_die
    with pytest.raises(_Die):
        hc.segment_all(seed_policy=policy)

    make, policy = ((make_port, GridSeeds) if writer == "jax"
                    else (make_jax, JaxGridSeeds))
    resumed = make(4, 3)
    assert resumed.restore_checkpoint(cpoint) == 0
    assert resumed.counters["fov-moves"].value == \
        hc.counters["fov-moves"].value > 0
    resumed.segment_all(seed_policy=policy)
    want = run_jax(4, 3)
    np.testing.assert_array_equal(np.maximum(resumed.segmentation, 0),
                                  np.maximum(want.segmentation, 0))
    assert sorted(o.iters for o in resumed.origins.values()) == \
        sorted(o.iters for o in want.origins.values())
    assert _counts(resumed)["fov-moves"] == _counts(want)["fov-moves"]
