"""ffn_tpu_torch's HopBatchCanvas (plain path) against the JAX package's:
test_canvas_e2e.py's volume with the rule-based oracle (every step exact)
and the same grid seeds; segmentations, origins and count counters
identical up to 64 lanes (speculative floods dropped as claimed). Device
finalization: test_torch_hop_canvas_devfin.py; lanes=1 and resume:
test_torch_hop_canvas_resume.py (split so test workers share the load);
the helpers here build both packages' canvases for them.
"""

import numpy as np
import pytest
import torch
from scipy.special import logit

from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import hop_engine as jax_hop_engine
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import hop_canvas, hop_engine
from ffn_tpu_torch.models import oracle
from test_canvas_e2e import DELTAS, FOV, make_image, make_options
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_torch_canvas import GridSeeds, _port_canvas

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

# One per queue capacity and seed dtype: its compiled programs are reused.
_JAX_ENGINES = {}


def _jax_engine(Q, seed_dtype=np.float32):
    key = (Q, np.dtype(seed_dtype).name)
    if key not in _JAX_ENGINES:
        opts = make_options()
        model = jax_oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                                deltas=list(DELTAS))
        _JAX_ENGINES[key] = (model, jax_hop_engine.HopEngine(
            model, {}, pad_value=float(logit(opts.pad_value)),
            move_threshold=float(logit(opts.move_threshold)),
            disco_seed_threshold=opts.disco_seed_threshold,
            queue_capacity=Q, seed_dtype=seed_dtype))
    return _JAX_ENGINES[key]


def _port_engine(Q, seed_dtype=torch.float32):
    options = _port_canvas(make_image()).options   # logit space
    model = oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                        deltas=list(DELTAS))
    return model, hop_engine.HopEngine(
        model, pad_value=options.pad_value,
        move_threshold=options.move_threshold,
        disco_seed_threshold=options.disco_seed_threshold,
        queue_capacity=Q, device="cpu", seed_dtype=seed_dtype)


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


def test_port_refuses_what_it_does_not_run(monkeypatch):
    # Device finalization is ported (test_hop_canvas_device_finalize_
    # matches_jax); as in the JAX canvas it stays off for one lane and for
    # probability maps.
    monkeypatch.setenv("FFN_TPU_DEVFIN", "1")
    assert make_port(4, 3).device_finalize
    assert not make_port(1, 3).device_finalize
    assert not make_port(4, 3, keep_probability_maps=True).device_finalize
