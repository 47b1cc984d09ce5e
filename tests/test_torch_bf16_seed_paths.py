"""ffn_tpu_torch with bfloat16 lane seeds on the device-finalize, fused,
round-based and serial paths against the JAX package with
seed_dtype=bfloat16 (the hop path: test_torch_bf16_seeds.py, whose
helpers this file shares). Crafted states on the thresholds' rounding
edges and a model reading its seed make every rounding show (K8's two
views of one origin, K13 at bf16(move_t), unrounded step returns): every
field bit for bit. With the oracle, the serial, round-based, device-
finalize and fused canvases give the JAX package's segmentations, origins
and counters, and checkpoints restore across the packages (a serial
restore rebuilds a float32 seed in both).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import batch_canvas as jax_batch_canvas
from ffn_tpu.inference import canvas as jax_canvas
from ffn_tpu.inference import engine as jax_engine
from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import hop_engine as jax_hop
from ffn_tpu_torch.inference import batch_canvas, canvas, engine, hop_canvas
from ffn_tpu_torch.inference import hop_engine
from ffn_tpu_torch.ops import finalize as fin_ops
from ffn_tpu_torch.ops import hop as hop_ops
from test_canvas_e2e import GridSeeds as JaxGridSeeds
from test_canvas_e2e import make_image, make_options
from test_torch_bf16_seeds import (DELTAS, FOV, MOVE_BF, MOVE_T, PAD, SEG_T,
                                   _engines, _JaxSeedModel, _PortSeedModel,
                                   _seeds32)
from test_torch_canvas import GridSeeds
from test_torch_hop_canvas import (_counts, _jax_engine, _origins,
                                   _port_engine, _port_options)
from test_torch_kernels import (bf16_edges, bf16_finalize_edges,
                                bf16_round_array, crafted_finalize)

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

LANE_FIELDS = list(jax_hop.LaneState.__dataclass_fields__)
FIN_FIELDS = list(jax_hop.FinalizeState.__dataclass_fields__)
SHAPE = (20, 22, 24)
EDGES = bf16_edges(MOVE_T, SEG_T)


def _finalize_inputs():
    """test_torch_kernels.crafted_finalize on bf16 seeds
    (bf16_finalize_edges): lane 16 RUNNING (not fresh) and lane 17
    DONE_EMPTY both have their origin at bf16(move_t) < move_t."""
    rng = np.random.RandomState(23)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, DELTAS, 5, 20)
    bf16_finalize_edges(rng, lanes, fin, opts, MOVE_T)
    image = rng.randn(2, *SHAPE).astype(np.float32)
    shapes = np.array([SHAPE, (SHAPE[0] - 2, SHAPE[1], SHAPE[2] - 1)],
                      np.int32)
    return lanes, fin, blocked, opts, image, shapes


@functools.lru_cache(maxsize=None)
def _engine_pair():
    return _engines(64, 0.0)


@pytest.mark.parametrize("hops", [1, 2])
def test_device_finalize_matches_jax(hops):
    jeng, peng = _engine_pair()
    lanes, fin, blocked, opts, image, shapes = _finalize_inputs()
    js = jax_hop.LaneState(**{
        k: jnp.asarray(lanes[k], jnp.bfloat16 if k == "seeds" else None)
        for k in LANE_FIELDS})
    jf = jax_hop.FinalizeState(**{k: jnp.asarray(fin[k])
                                  for k in FIN_FIELDS})
    js, jf, want = jeng.run_hops(
        jnp.asarray(image), jnp.asarray(blocked), js, hops, 5, shapes=shapes,
        sync=False, fstate=jf, fin_opts=opts)

    def t(a):
        return torch.from_numpy(np.array(a))

    ps = hop_engine.LaneState(**{k: t(lanes[k]) for k in LANE_FIELDS})
    ps.seeds = ps.seeds.to(torch.bfloat16)
    pf = hop_engine.FinalizeState(**{k: t(fin[k]) for k in FIN_FIELDS})
    ps, pf, got = peng.run_hops(
        torch.from_numpy(image), torch.from_numpy(blocked), ps, hops, 5,
        shapes=shapes, sync=False, fstate=pf, fin_opts=opts)
    assert ps.seeds.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in LANE_FIELDS:
        g, w = getattr(ps, name), getattr(js, name)
        if name == "seeds":
            np.testing.assert_array_equal(_seeds32(g), _seeds32(w))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    for name in FIN_FIELDS:
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    _, rows, _, _ = peng.unpack_round(got, 24, 2)
    outcome = {}   # each lane's first finalization
    for r in rows:
        outcome.setdefault(int(r[9]), int(r[8]))
    # The same origin: weak to the dud kill, strong to the verdict.
    assert outcome[16] == fin_ops.FIN_WEAK
    assert outcome[17] == fin_ops.FIN_SEGMENTED
    assert set(rows[:, 8].tolist()) == {1, 2, 3, 4, 5}


# -- K13, K14: the round-based step -------------------------------------------


def _flood_engines(pred, disco):
    kw = dict(pad_value=PAD, move_threshold=MOVE_T,
              disco_seed_threshold=disco)
    return (jax_engine.FloodFillEngine(_JaxSeedModel(pred), {},
                                       seed_dtype=jnp.bfloat16, **kw),
            engine.FloodFillEngine(_PortSeedModel(pred), device="cpu",
                                   seed_dtype=torch.bfloat16, **kw))


def _crafted_seeds(rng, B):
    seeds = (rng.randn(B, *SHAPE) * 3).astype(np.float32)
    seeds[rng.rand(*seeds.shape) < 0.3] = np.nan
    edge = rng.rand(*seeds.shape) < 0.15
    seeds[edge] = rng.choice(EDGES, size=int(edge.sum()))
    return bf16_round_array(seeds)


def _crafted_round(rng, seeds, K=3):
    """(candidates (B,K,3), start (B,3), active, ignore): starts and
    candidates at bf16(move_t) (below move_t) and above it, NaN, faces."""
    B = seeds.shape[0]
    dims = np.array(SHAPE)
    cands = rng.randint(-2, dims + 2, size=(B, K, 3)).astype(np.int32)
    start = rng.randint(0, dims, size=(B, 3)).astype(np.int32)
    above = np.float32(bf16_round_array([MOVE_T + 0.5])[0])
    for b in range(B):
        seeds[(b,) + tuple(start[b])] = above
        idx = np.clip(np.where(cands[b] < 0, cands[b] + dims, cands[b]), 0,
                      dims - 1)
        for k in range(K):   # candidate values on the edges, or strong
            seeds[(b,) + tuple(idx[k])] = rng.choice(
                [MOVE_BF, above, np.nan, EDGES[1], EDGES[2]])
    seeds[(1,) + tuple(start[1])] = MOVE_BF    # a start below move_t
    seeds[(2,) + tuple(start[2])] = np.nan
    active = rng.rand(B) < 0.9
    ignore = np.zeros(B, bool)
    ignore[[0, 5]] = True
    return cands, start, active, ignore


@pytest.mark.parametrize("pred,disco", [(9, 0.0), (7, -1.0), (9, 0.3)])
def test_select_step_matches_jax(pred, disco):
    jeng, peng = _flood_engines(pred, disco)
    rng = np.random.RandomState(41)
    image = (rng.randn(*SHAPE) * 2).astype(np.float32)
    seeds = _crafted_seeds(rng, 12)
    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jseeds = jnp.asarray(seeds, jnp.bfloat16)
    pseeds = torch.from_numpy(seeds).to(torch.bfloat16)
    executed = 0
    for _ in range(3):   # the seeds evolve from round to round
        host = _seeds32(jseeds).copy()
        args = _crafted_round(rng, host)
        jseeds = jnp.asarray(host, jnp.bfloat16)
        pseeds.copy_(torch.from_numpy(host))
        jseeds, want = jeng.select_step(jimg, jseeds, *args)
        pseeds, got = peng.select_step(pimg, pseeds, *args)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
        assert pseeds.dtype == torch.bfloat16
        np.testing.assert_array_equal(_seeds32(pseeds), _seeds32(jseeds))
        assert not got["start_ok"][1] and not got["executed"][[1, 2]].any()
        executed += int(got["executed"].sum())
    assert executed >= 12


@pytest.mark.parametrize("pred", [9, 7])
def test_step_batch_returns_unrounded_logits(pred):
    jeng, peng = _flood_engines(pred, 0.0)
    rng = np.random.RandomState(43)
    image = (rng.randn(*SHAPE) * 2 + 1e-3).astype(np.float32)
    seeds = _crafted_seeds(rng, 9)
    pos = rng.randint(0, SHAPE, size=(9, 3)).astype(np.int32)
    active = rng.rand(9) < 0.8
    jseeds, want = jeng.step_batch(jeng.put_image(image),
                                   jnp.asarray(seeds, jnp.bfloat16), pos,
                                   active)
    pseeds, got = peng.step_batch(peng.put_image(image),
                                  torch.from_numpy(seeds).to(torch.bfloat16),
                                  pos, active)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(_seeds32(pseeds), _seeds32(jseeds))
    # The returned logits are not the stored (rounded) values.
    assert not np.array_equal(got, bf16_round_array(got))


def test_lane_resets_match_jax():
    jeng, peng = _flood_engines(9, 0.0)
    rng = np.random.RandomState(44)
    seeds = _crafted_seeds(rng, 5)
    init = 2.2   # rounds in bfloat16
    mask = np.array([True, False, True, False, False])
    pos = rng.randint(0, SHAPE, size=(5, 3)).astype(np.int32)
    want = jeng.reset_lanes(jnp.asarray(seeds, jnp.bfloat16), mask, pos, init)
    got = peng.reset_lanes(torch.from_numpy(seeds).to(torch.bfloat16), mask,
                           pos, init)
    np.testing.assert_array_equal(_seeds32(got), _seeds32(want))
    want = jeng.reset_seed_lane(jnp.asarray(seeds, jnp.bfloat16), 3, pos[3],
                                init)
    got = peng.reset_seed_lane(torch.from_numpy(seeds).to(torch.bfloat16), 3,
                               pos[3], init)
    np.testing.assert_array_equal(_seeds32(got), _seeds32(want))
    want = jeng.reset_seed(jeng.new_seed_buffer(SHAPE), pos[0], init)
    got = peng.reset_seed(peng.new_seed_buffer(SHAPE), pos[0], init)
    assert got.dtype == peng.new_seed_batch(2, SHAPE).dtype == torch.bfloat16
    np.testing.assert_array_equal(_seeds32(got), _seeds32(want))
    assert float(got[tuple(pos[0])]) == hop_ops.bf16_round(init)


# -- K2, K3: the serial step --------------------------------------------------


@pytest.mark.parametrize("pred,disco", [(9, 0.0), (7, -1.0)])
def test_step_matches_jax(pred, disco):
    jeng, peng = _flood_engines(pred, disco)
    rng = np.random.RandomState(45)
    image = (rng.randn(*SHAPE) * 2 + 1e-3).astype(np.float32)
    seed = _crafted_seeds(rng, 1)[0]
    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jseed = jnp.asarray(seed, jnp.bfloat16)
    pseed = torch.from_numpy(seed).to(torch.bfloat16)
    positions = [(10, 11, 12), (0, 0, 0), (19, 21, 23), (2, 20, 5),
                 (10, 11, 12), (12, 9, 14)]
    for pos in positions:
        jseed, want = jeng.step(jimg, jseed, pos)
        pseed, got = peng.step(pimg, pseed, pos)
        assert got.dtype == np.float32 and pseed.dtype == torch.bfloat16
        np.testing.assert_array_equal(got, want)   # unrounded, as JAX's
        np.testing.assert_array_equal(_seeds32(pseed), _seeds32(jseed))
    assert not np.array_equal(got, bf16_round_array(got))


# -- the canvases with the oracle model ---------------------------------------


def _serial_engines():
    from scipy.special import logit
    from ffn_tpu.models import oracle as jax_oracle
    from ffn_tpu_torch.models import oracle
    from test_canvas_e2e import DELTAS as ODELTAS
    from test_canvas_e2e import FOV as OFOV
    opts = make_options()
    kw = dict(pad_value=float(logit(opts.pad_value)),
              move_threshold=float(logit(opts.move_threshold)),
              disco_seed_threshold=opts.disco_seed_threshold)
    mkw = dict(fov_size=[OFOV] * 3, deltas=list(ODELTAS))
    jmodel = jax_oracle.ThresholdOracleModel(**mkw)
    pmodel = oracle.ThresholdOracleModel(**mkw)
    return ((jmodel, jax_engine.FloodFillEngine(
                jmodel, {}, seed_dtype=jnp.bfloat16, **kw)),
            (pmodel, engine.FloodFillEngine(
                pmodel, device="cpu", seed_dtype=torch.bfloat16, **kw)))


def make_canvas(side, kind, lanes=1, **kwargs):
    """A bf16-seed canvas of `kind` (serial, round, devfin) on either
    side, on test_canvas_e2e.py's volume."""
    jax_side = side == "jax"
    if kind == "serial":
        (jmodel, jeng), (pmodel, peng) = _serial_engines()
        if jax_side:
            return jax_canvas.Canvas(jmodel.info, jeng, make_image(),
                                     make_options(), **kwargs)
        return canvas.Canvas(pmodel.info, peng, make_image(),
                             _port_options(), **kwargs)
    model, eng = (_jax_engine(4096, jnp.bfloat16) if jax_side
                  else _port_engine(4096, torch.bfloat16))
    opts = make_options() if jax_side else _port_options()
    if kind == "round":
        cls = jax_batch_canvas.BatchCanvas if jax_side else \
            batch_canvas.BatchCanvas
        return cls(model.info, eng, make_image(), opts, lanes=lanes,
                   candidates_per_step=4, **kwargs)
    cls = jax_hop_canvas.HopBatchCanvas if jax_side else \
        hop_canvas.HopBatchCanvas
    return cls(model.info, eng, make_image(), opts, lanes=lanes, hops=3,
               device_finalize=True, **kwargs)


def _seed_of(cv):
    """The canvas's device seeds as float32 numpy."""
    for name in ("_seed_dev", "_seeds_dev"):
        if getattr(cv, name, None) is not None:
            return _seeds32(getattr(cv, name))
    return _seeds32(cv._state.seeds)


def _dtype_of(cv):
    for name in ("_seed_dev", "_seeds_dev"):
        if getattr(cv, name, None) is not None:
            return getattr(cv, name).dtype
    return cv._state.seeds.dtype


_JAX_RUNS = {}


def _jax_run(kind, lanes):
    """The JAX canvas's uninterrupted run, shared by the tests."""
    if (kind, lanes) not in _JAX_RUNS:
        cv = make_canvas("jax", kind, lanes)
        cv.segment_all(seed_policy=JaxGridSeeds)
        _JAX_RUNS[kind, lanes] = cv
    return _JAX_RUNS[kind, lanes]


@pytest.mark.parametrize("kind,lanes", [
    ("serial", 1), ("round", 2), ("round", 4), ("devfin", 2), ("devfin", 4)])
def test_canvas_matches_jax(kind, lanes):
    want = _jax_run(kind, lanes)
    got = make_canvas("torch", kind, lanes)
    assert _dtype_of(got) == torch.bfloat16
    got.segment_all(seed_policy=GridSeeds)
    assert _dtype_of(got) == torch.bfloat16
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want) and len(got.origins) >= 2
    assert _counts(got) == _counts(want)
    np.testing.assert_array_equal(_seed_of(got), _seed_of(want))
    if kind == "serial":   # the host mirror keeps the unrounded logits
        np.testing.assert_array_equal(got.seed, want.seed)
    if kind == "devfin":
        assert got.device_finalize and want.device_finalize


class _Die(Exception):
    pass


def _interrupt(cv, policy, cpoint, die_after):
    cv.checkpoint_path = cpoint
    cv.checkpoint_interval_sec = 1e-9
    saves = {"n": 0}
    save = cv.save_checkpoint

    def save_and_maybe_die(*args, **kwargs):
        save(*args, **kwargs)
        saves["n"] += 1
        if saves["n"] >= die_after:
            raise _Die()

    cv.save_checkpoint = save_and_maybe_die
    with pytest.raises(_Die):
        cv.segment_all(seed_policy=policy)


_POLICY = {"jax": JaxGridSeeds, "torch": GridSeeds}


@pytest.mark.parametrize("kind,writer", [
    ("serial", "jax"), ("serial", "torch"), ("round", "jax"),
    ("round", "torch"), ("devfin", "jax"), ("devfin", "torch")])
def test_checkpoint_restores_across_packages(tmp_path, kind, writer):
    """A bf16-seed checkpoint written mid-run by either package, restored by
    both: the two resumed runs agree with each other and, with the oracle,
    with the uninterrupted one. The serial restore rebuilds a float32
    device seed in both packages (canvas.py:394-397); the batched ones
    round the lanes' float32 regions back into bf16 seeds."""
    cpoint = str(tmp_path / "cpoint.npz")
    lanes = 1 if kind == "serial" else 4
    _interrupt(make_canvas(writer, kind, lanes), _POLICY[writer], cpoint,
               die_after=12 if kind == "serial" else 4)
    resumed = {}
    for side in ("jax", "torch"):
        cv = make_canvas(side, kind, lanes)
        partial = cv.restore_checkpoint(cpoint)
        if kind == "serial":
            assert partial > 0   # the checkpoint holds a segment in flight
            want_dtype = np.float32 if side == "jax" else torch.float32
            assert _dtype_of(cv) == want_dtype
            cv.segment_all(seed_policy=_POLICY[side],
                           partial_segment_iters=partial)
            assert _dtype_of(cv) == want_dtype
        else:
            assert partial == 0
            cv.segment_all(seed_policy=_POLICY[side])
            assert _dtype_of(cv) in (jnp.bfloat16, torch.bfloat16)
        resumed[side] = cv
    got, want = resumed["torch"], resumed["jax"]
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want)
    np.testing.assert_array_equal(_seed_of(got), _seed_of(want))
    full = _jax_run(kind, lanes)
    np.testing.assert_array_equal(np.maximum(got.segmentation, 0),
                                  np.maximum(full.segmentation, 0))
    assert sorted(o.iters for o in got.origins.values()) == \
        sorted(o.iters for o in full.origins.values())


# -- the fused driver ---------------------------------------------------------


@pytest.mark.parametrize("name", ["devfin", "host"])
def test_fused_driver_matches_jax(tmp_path, monkeypatch, name):
    """test_torch_multi_canvas.py's fused comparison (8 lanes, 2 slots, 4
    hops, two subvolumes) with FFN_TPU_SEED_DTYPE=bf16 in both Runners."""
    from test_torch_multi_canvas import _run
    monkeypatch.setenv("FFN_TPU_SEED_DTYPE", "bf16")
    for side in "jt":
        (tmp_path / side).mkdir()
    want, (jr, _) = _run("jax", tmp_path / "j", name)
    got, (r, _) = _run("torch", tmp_path / "t", name)
    assert jr.engine.seed_dtype == jnp.bfloat16
    assert r.engine.seed_dtype == torch.bfloat16
    (saved, subvolumes, stats), (wsaved, wsubvolumes, wstats) = got, want
    assert saved == wsaved >= 2
    for (seg, origins, counts), (wseg, worigins, wcounts) in zip(
            subvolumes, wsubvolumes):
        np.testing.assert_array_equal(seg, wseg)
        assert origins == worigins and origins
        assert counts == wcounts
    assert stats == wstats
