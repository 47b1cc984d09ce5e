"""ffn_tpu_torch's HopBatchCanvas (plain path) against the JAX package's.

Both canvases segment test_canvas_e2e.py's synthetic volume with the
rule-based oracle model and the same grid seeds; the oracle makes every
step exact, so the segmentations, the origins (position and iterations)
and every count counter must be identical (timers are not compared), up to
64 lanes, where lanes outnumber the seeds and speculative floods are
dropped as already claimed. Also:
lanes=1 equals the port's serial Canvas, and a run killed after a
checkpoint resumes to the uninterrupted result.
"""

import numpy as np
import pytest
from scipy.special import logit

from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import hop_engine as jax_hop_engine
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import batch_canvas, hop_canvas, hop_engine
from ffn_tpu_torch.models import oracle
from test_canvas_e2e import DELTAS, FOV, make_image, make_options
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_torch_canvas import GridSeeds, _port_canvas

_JAX_ENGINES = {}   # one per queue capacity: its compiled programs are reused


def _jax_engine(Q):
    if Q not in _JAX_ENGINES:
        opts = make_options()
        model = jax_oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                                deltas=list(DELTAS))
        _JAX_ENGINES[Q] = (model, jax_hop_engine.HopEngine(
            model, {}, pad_value=float(logit(opts.pad_value)),
            move_threshold=float(logit(opts.move_threshold)),
            disco_seed_threshold=opts.disco_seed_threshold,
            queue_capacity=Q))
    return _JAX_ENGINES[Q]


def _port_engine(Q):
    options = _port_canvas(make_image()).options   # logit space
    model = oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                        deltas=list(DELTAS))
    return model, hop_engine.HopEngine(
        model, pad_value=options.pad_value,
        move_threshold=options.move_threshold,
        disco_seed_threshold=options.disco_seed_threshold,
        queue_capacity=Q, device="cpu")


def _port_options():
    opts = make_options()
    from ffn_tpu_torch.inference.settings import InferenceOptions
    return InferenceOptions(
        init_activation=opts.init_activation, pad_value=opts.pad_value,
        move_threshold=opts.move_threshold,
        segment_threshold=opts.segment_threshold,
        min_segment_size=opts.min_segment_size,
        disco_seed_threshold=opts.disco_seed_threshold,
        min_boundary_dist=(1, 1, 1))


def run_jax(lanes, hops, Q=4096, compact_window=None, **kwargs):
    model, eng = _jax_engine(Q)
    hc = jax_hop_canvas.HopBatchCanvas(model.info, eng, make_image(),
                                       make_options(), lanes=lanes,
                                       hops=hops, **kwargs)
    if compact_window is not None:
        hc._compact_window = compact_window
    hc.segment_all(seed_policy=JaxGridSeeds)
    return hc


def make_port(lanes, hops, Q=4096, compact_window=None, **kwargs):
    model, eng = _port_engine(Q)
    hc = hop_canvas.HopBatchCanvas(model.info, eng, make_image(),
                                   _port_options(), lanes=lanes, hops=hops,
                                   **kwargs)
    if compact_window is not None:
        hc._compact_window = compact_window
    return hc


def run_port(lanes, hops, Q=4096, compact_window=None, **kwargs):
    hc = make_port(lanes, hops, Q, compact_window, **kwargs)
    hc.segment_all(seed_policy=GridSeeds)
    return hc


def _origins(canvas):
    return {k: (tuple(int(v) for v in o.start_zyx), o.iters)
            for k, o in canvas.origins.items()}


def _counts(canvas):
    return {name: c.value for name, c in canvas.counters
            if not name.endswith("-ms")}


@pytest.mark.parametrize("lanes,hops,Q,kwargs", [
    (1, 3, 4096, {}), (1, 8, 4096, {}), (1, 17, 4096, {}),
    (4, 3, 4096, {}), (4, 8, 4096, {}), (4, 17, 4096, {}),
    (12, 4, 4096, dict(compact_window=1, seed_screening=False)),
    (64, 8, 4096, {}),    # more lanes than seeds: duplicate floods dropped
    (1, 8, 16, {})])      # stall, drain, spill and requeue
def test_hop_canvas_matches_jax(lanes, hops, Q, kwargs):
    want = run_jax(lanes, hops, Q, **kwargs)
    got = run_port(lanes, hops, Q, **kwargs)
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want) and len(got.origins) >= 2
    assert _counts(got) == _counts(want)
    assert got.lanes == want.lanes
    if "compact_window" in kwargs:
        assert got.lanes < lanes, "compaction did not trigger"
    if Q == 16:
        assert got.counters["queue-stall-drains"].value > 0
    if lanes == 64:
        assert got.counters["seed-claimed-drops"].value > 0


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


def test_port_refuses_what_it_does_not_run(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="device finalization"):
        make_port(4, 3, device_finalize=True)
    monkeypatch.setenv("FFN_TPU_DEVFIN", "1")
    with pytest.raises(NotImplementedError, match="FFN_TPU_DEVFIN"):
        make_port(4, 3)
    monkeypatch.delenv("FFN_TPU_DEVFIN")
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, segmentation=np.zeros((36, 36, 36), np.int32))
    with pytest.raises(NotImplementedError, match="round-based"):
        make_port(2, 3).restore_checkpoint(legacy)
    model, eng = _port_engine(64)
    with pytest.raises(NotImplementedError, match="hops=0"):
        batch_canvas.BatchCanvas(model.info, eng, make_image(),
                                 _port_options(), lanes=2).segment_all()
