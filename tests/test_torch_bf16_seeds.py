"""ffn_tpu_torch with bfloat16 lane seeds against the JAX package's
HopEngine(seed_dtype=bfloat16) on the hop path with host finalization:
K4-K7's plain versions, HopBatchCanvas, checkpoints and the Runner. The
crafted states hold seeds on the thresholds' rounding edges and NaN (K4
counts bf16(move_t) <= v < move_t weak, K7 strong, in both packages); a
test model reading its seed (exact in both) and the rule-based oracle
make the rounding show: every field bit for bit. With the CI checkpoint
(float32 logits off in the last digits) every decision still agrees on
this phantom, so the Runner pair is held to equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import hop_engine as jax_hop
from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.models import model_info as jax_model_info
from ffn_tpu_torch.inference import hop_canvas, hop_engine, runner
from ffn_tpu_torch.models import model_info
from ffn_tpu_torch.ops import hop as hop_ops
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_canvas_e2e import make_image, make_options
from test_torch_canvas import GridSeeds
from test_torch_hop_canvas import (_counts, _jax_engine, _origins,
                                   _port_engine, _port_options)
from test_torch_hop_engine import FIELDS
from test_torch_kernels import crafted_lanes
from test_torch_runner import PAD as IMG_PAD
from test_torch_runner import _request

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

PAD = float(np.log(0.05 / 0.95))
# logit(0.8) rounds DOWN to bfloat16 (1.3828125 < 1.3862944), so a stored
# seed of bf16(MOVE_T) is weak to K4 and strong to K7.
MOVE_T = float(np.float32(np.log(0.8 / 0.2)))
MOVE_BF = hop_ops.bf16_round(MOVE_T)
SEG_T = float(np.float32(0.299))       # rounds down too: 0.298828125
SEG_BF = hop_ops.bf16_round(SEG_T)
DELTAS = (2, 3, 2)                     # zyx
FOV = 9


class _JaxSeedModel:
    """2 image + seed / 2: reads the seed, exact in float32; the engine
    crops `pred`."""

    def __init__(self, pred=FOV):
        self.info = jax_model_info.ModelInfo(
            deltas=list(DELTAS[::-1]), pred_mask_size=[pred] * 3,
            input_seed_size=[FOV] * 3, input_image_size=[FOV] * 3,
            additive=False)

    def apply(self, params, image, seed):
        return image * 2.0 + seed.astype(jnp.float32) * 0.5


class _PortSeedModel:
    def __init__(self, pred=FOV):
        self.info = model_info.ModelInfo(
            deltas=list(DELTAS[::-1]), pred_mask_size=[pred] * 3,
            input_seed_size=[FOV] * 3, input_image_size=[FOV] * 3,
            additive=False)

    def apply(self, image, seed):
        return image * 2.0 + seed.float() * 0.5


def _engines(Q, disco):
    kw = dict(pad_value=PAD, move_threshold=MOVE_T,
              disco_seed_threshold=disco, queue_capacity=Q)
    return (jax_hop.HopEngine(_JaxSeedModel(), {}, seed_dtype=jnp.bfloat16,
                              **kw),
            hop_engine.HopEngine(_PortSeedModel(), device="cpu",
                                 seed_dtype=torch.bfloat16, **kw))


def _states(lanes):
    """Both packages' LaneState of numpy `lanes`, seeds rounded to bf16."""
    jax_fields = {k: jnp.asarray(lanes[k]) for k in FIELDS}
    jax_fields["seeds"] = jnp.asarray(lanes["seeds"], jnp.bfloat16)
    port_fields = {k: torch.from_numpy(np.ascontiguousarray(lanes[k]))
                   for k in FIELDS}
    port_fields["seeds"] = port_fields["seeds"].to(torch.bfloat16)
    return jax_hop.LaneState(**jax_fields), hop_engine.LaneState(
        **port_fields)


def _seeds32(seeds):
    if isinstance(seeds, torch.Tensor):
        return seeds.float().numpy()
    return np.asarray(seeds.astype(jnp.float32))


def _compare(jstate, pstate):
    assert pstate.seeds.dtype == torch.bfloat16
    for name in FIELDS:
        want, got = getattr(jstate, name), getattr(pstate, name)
        if name == "seeds":
            np.testing.assert_array_equal(_seeds32(got), _seeds32(want))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)


def _crafted(rng, B, shape, Q):
    lanes = crafted_lanes(rng, B, shape, Q, FOV, DELTAS, 4)
    seeds = lanes["seeds"]
    # Seeds on the thresholds' rounding edges and just off them.
    edge = rng.rand(*seeds.shape) < 0.15
    seeds[edge] = rng.choice(np.float32([
        MOVE_BF, MOVE_T, np.nextafter(np.float32(MOVE_BF), 10),
        SEG_BF, SEG_T, PAD]), size=int(edge.sum()))
    # Lane 11: not fresh, its origin at bf16(move_t) < move_t (weak at pop).
    lanes["status"][11], lanes["fresh"][11] = 1, False
    seeds[(11,) + tuple(lanes["start"][11])] = MOVE_BF
    return lanes


@pytest.mark.parametrize("disco,Q", [(0.0, 64), (-1.0, 16)])
def test_crafted_hops_and_reads_match_jax(disco, Q):
    rng = np.random.RandomState(31)
    shape = (22, 24, 26)
    jeng, peng = _engines(Q, disco)
    lanes = _crafted(rng, 12, shape, Q)
    image = (rng.randn(*shape) * 2).astype(np.float32)
    blocked = lanes["blocked"][0]
    jstate, pstate = _states(lanes)
    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jblk, pblk = jeng.put_blocked(blocked), peng.put_blocked(blocked)

    # The reads on the crafted state: K7's thresholds rounded to bf16.
    got = peng.lane_verdicts(pstate, pblk, SEG_T, MOVE_T)
    want = jeng.lane_verdicts(jstate, jblk, SEG_T, MOVE_T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][11], "K7 counts bf16(move_t) as strong"
    statuses = []
    for r in range(3):
        jstate, jaux = jeng.run_hops(jimg, jblk, jstate, 3, 4)
        pstate, paux = peng.run_hops(pimg, pblk, pstate, 3, 4)
        _compare(jstate, pstate)
        for key in jaux:
            np.testing.assert_array_equal(paux[key], jaux[key], err_msg=key)
        statuses.append(paux["status"].copy())
        if r == 0:   # K4 kills lane 11 as weak on the same value
            assert statuses[0][11] == hop_engine.DONE_WEAK
    assert int(pstate.iters.sum()) > 12
    assert (statuses[-1] == hop_engine.DONE_EMPTY).any()
    if Q == 16:
        assert (np.stack(statuses) == hop_engine.STALLED_FULL).any()
    # The written seeds are bf16 values, rounded from float32 logits.
    assert pstate.seeds.dtype == torch.bfloat16

    got = peng.lane_verdicts(pstate, pblk, SEG_T, MOVE_T)
    want = jeng.lane_verdicts(jstate, jblk, SEG_T, MOVE_T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    boxes = [(0, (3, 4, 5), (10, 20, 2)), (9, (12, 13, 11), (9, 7, 9)),
             (11, (-3, 0, 0), (30, 30, 30)), (2, (0, 0, 0), (22, 24, 26))]
    for lane, start, size in boxes:
        origin = lanes["start"][lane]
        for thr in (SEG_T, MOVE_BF):
            g = peng.lane_mask_region(pstate.seeds, lane, start, size, thr,
                                      origin)
            w = jeng.lane_mask_region(jstate.seeds, lane, start, size, thr,
                                      origin)
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2]
        g = peng.lane_seed_region(pstate.seeds, lane, start, size)
        w = jeng.lane_seed_region(jstate.seeds, lane, start, size)
        assert g[0].dtype == np.float32
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    args = ([b[0] for b in boxes], [b[1] for b in boxes],
            [b[2] for b in boxes], SEG_T,
            [lanes["start"][b[0]] for b in boxes])
    for g, w in zip(peng.lane_mask_regions(pstate.seeds, *args),
                    jeng.lane_mask_regions(jstate.seeds, *args)):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[2] == w[2]
    assert peng.lane_mask_regions(pstate.seeds, [11], [(0, 0, 0)],
                                  [(1, 1, 1)], SEG_T,
                                  [lanes["start"][11]])[0][2]

    # A checkpoint restore rounds a float32 region into the bf16 seeds.
    region = (rng.randn(9, 7, 9) * 3).astype(np.float32)
    region[0, 0, :3] = [MOVE_T, SEG_T, np.nan]
    pseeds = peng.set_lane_seed_region(pstate.seeds, 1, (10, 13, 11), region)
    jseeds = jeng.set_lane_seed_region(jstate.seeds, 1, (10, 13, 11), region)
    np.testing.assert_array_equal(_seeds32(pseeds), _seeds32(jseeds))
    # The JAX engine donated the old seeds to set_lane_seed_region.
    jstate = dataclasses.replace(jstate, seeds=jseeds)
    keep = [9, 0, 0, 2]
    _compare(jeng.compact_lanes(jstate, keep),
             peng.compact_lanes(pstate, keep))

    # The reseed plants init_activation rounded to bf16.
    mask = np.zeros(12, bool)
    mask[[3, 4]] = True
    pos = np.tile(np.int32([[11, 12, 13]]), (12, 1))
    jstate = jeng.reseed_lanes(jstate, mask, pos, 2.2)
    pstate = peng.reseed_lanes(pstate, mask, pos, 2.2)
    _compare(jstate, pstate)
    assert float(pstate.seeds[3, 11, 12, 13]) == hop_ops.bf16_round(2.2)


def _jax_canvas(lanes, hops, **kwargs):
    model, eng = _jax_engine(4096, jnp.bfloat16)
    return jax_hop_canvas.HopBatchCanvas(model.info, eng, make_image(),
                                         make_options(), lanes=lanes,
                                         hops=hops, **kwargs)


def _port_canvas(lanes, hops, **kwargs):
    model, eng = _port_engine(4096, torch.bfloat16)
    return hop_canvas.HopBatchCanvas(model.info, eng, make_image(),
                                     _port_options(), lanes=lanes, hops=hops,
                                     **kwargs)


_JAX_RUNS = {}


def _jax_run(lanes):
    """The JAX canvas's uninterrupted run, shared by the tests."""
    if lanes not in _JAX_RUNS:
        _JAX_RUNS[lanes] = _jax_canvas(lanes, 3)
        _JAX_RUNS[lanes].segment_all(seed_policy=JaxGridSeeds)
    return _JAX_RUNS[lanes]


@pytest.mark.parametrize("lanes", [2, 4])
def test_hop_canvas_matches_jax(lanes):
    want = _jax_run(lanes)
    got = _port_canvas(lanes, 3)
    assert got._state.seeds.dtype == torch.bfloat16
    got.segment_all(seed_policy=GridSeeds)
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want) and len(got.origins) >= 2
    assert _counts(got) == _counts(want)


class _Die(Exception):
    pass


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bf16_checkpoint_restores_across_packages(tmp_path, writer):
    """A hop-format checkpoint of bf16 lanes, saved by either package, in
    the other: the in-flight lanes' regions download as float32 and round
    back into bf16 on restore, and the run ends as the uninterrupted one."""
    cpoint = str(tmp_path / "cpoint.npz")
    make, policy = ((_jax_canvas, JaxGridSeeds) if writer == "jax"
                    else (_port_canvas, GridSeeds))
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
    make, policy = ((_port_canvas, GridSeeds) if writer == "jax"
                    else (_jax_canvas, JaxGridSeeds))
    resumed = make(4, 3)
    assert resumed.restore_checkpoint(cpoint) == 0
    assert resumed.counters["fov-moves"].value == \
        hc.counters["fov-moves"].value > 0
    resumed.segment_all(seed_policy=policy)
    want = _jax_run(4)
    np.testing.assert_array_equal(np.maximum(resumed.segmentation, 0),
                                  np.maximum(want.segmentation, 0))
    assert sorted(o.iters for o in resumed.origins.values()) == \
        sorted(o.iters for o in want.origins.values())


def _run_counts(counters):
    return {name: c.value for name, c in counters if not name.endswith("-ms")}


def test_bf16_seed_runner_matches_jax_runner(tmp_path, monkeypatch):
    """FFN_TPU_SEED_DTYPE=bf16 in both Runners, 4 lanes, the CI checkpoint
    (float32 ConvStack) on the 32^3 phantom padded to 48^3: the same
    segmentation, origins and counters (measured equal; the tolerance is
    equality)."""
    monkeypatch.setenv("FFN_TPU_SEED_DTYPE", "bf16")
    size = 32
    box = (size + 2 * IMG_PAD,) * 3
    request, _ = _request(tmp_path, tmp_path / "jax", size=size)
    request.concurrent_requests = 4
    want = jax_runner.Runner()
    want.start(request)
    assert want.engine.seed_dtype == jnp.bfloat16
    want_canvas = want.run((0, 0, 0), box, keep_probability_maps=False)
    request.segmentation_output_dir = str(tmp_path / "torch")
    got = runner.Runner(device="cpu")
    got.start(request)
    got_canvas = got.run((0, 0, 0), box, keep_probability_maps=False)
    assert isinstance(got_canvas, hop_canvas.HopBatchCanvas)
    assert not got_canvas.device_finalize
    assert got_canvas._state.seeds.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_canvas.segmentation,
                                  want_canvas.segmentation)
    assert {k: (tuple(v.start_zyx), v.iters)
            for k, v in got_canvas.origins.items()} == \
        {k: (tuple(v.start_zyx), v.iters)
         for k, v in want_canvas.origins.items()}
    assert _run_counts(got.counters) == _run_counts(want.counters)
    assert got.counters["fov-moves"].value > 0 and len(got_canvas.origins) > 1
