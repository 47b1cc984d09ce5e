"""ffn_tpu_torch's HopEngine (plain path) against the JAX HopEngine: the same
numpy LaneState through both engines' run_hops for a few rounds, the whole
state and aux compared each round; the oracle bit for bit; the CI
checkpoint's seeds within 1e-5 (same NaN pattern), integer state exact.
Also the face-move order, finalize reads, the blocked OR at a face, seed
screening and lane compaction.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import hop_engine as jax_hop
from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import hop_engine
from ffn_tpu_torch.models import convstack_3d, oracle, params_io
from ffn_tpu_torch.ops import hop as hop_ops
from test_torch_kernels import crafted_lanes, tied_logits

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "models", "phantom", "model-ci-tiny.npz")
PAD = float(np.log(0.05 / 0.95))
MOVE_T = float(np.log(0.9 / 0.1))
FIELDS = [f for f in jax_hop.LaneState.__dataclass_fields__]


def _engines(kind, Q, disco=0.0):
    thresholds = dict(pad_value=PAD, move_threshold=MOVE_T,
                      disco_seed_threshold=disco, queue_capacity=Q)
    if kind == "oracle":
        kw = dict(fov_size=[9] * 3, deltas=[2, 3, 2])
        jmodel, params = jax_oracle.ThresholdOracleModel(**kw), {}
        pmodel = oracle.ThresholdOracleModel(**kw)
    else:  # the shipped tiny CI checkpoint: 17^3 FOV, depth 2, 16 features
        kw = dict(fov_size=[17] * 3, deltas=[6] * 3, depth=2, features=16)
        flat = params_io.load_params_npz(TINY)
        params = {"params": {}}
        for key, value in flat.items():
            _, layer, leaf = key.split("/")
            params["params"].setdefault(layer, {})[leaf] = value
        jmodel = jax_convstack.ConvStack3DFFNModel(**kw)
        pmodel = convstack_3d.ConvStack3DFFNModel(**kw)
        pmodel.load_params(params)   # through params_io.convert_params
    return (jax_hop.HopEngine(jmodel, params, **thresholds),
            hop_engine.HopEngine(pmodel, device="cpu", **thresholds))


def _lane_states(lanes):
    jstate = jax_hop.LaneState(**{k: jnp.asarray(lanes[k]) for k in FIELDS})
    pstate = hop_engine.LaneState(**{
        k: torch.from_numpy(np.ascontiguousarray(lanes[k])) for k in FIELDS})
    return jstate, pstate


def _compare(jstate, pstate, exact):
    for name in FIELDS:
        want = np.asarray(getattr(jstate, name))
        got = getattr(pstate, name).numpy()
        if name == "seeds" and not exact:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        elif name == "qscore" and not exact:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kind,Q,max_iters,hops", [
    ("oracle", 16, 4, 3),     # stalls: the queue holds 16
    ("oracle", 64, 0, 5),     # stale runs of 20 entries of every kind
    ("convstack", 64, 3, 2)])
def test_run_hops_matches_jax(kind, Q, max_iters, hops):
    rng = np.random.RandomState(21)
    fov = 9 if kind == "oracle" else 17
    deltas = (2, 3, 2) if kind == "oracle" else (6, 6, 6)
    shape = (22, 24, 26) if kind == "oracle" else (26, 27, 28)
    jeng, peng = _engines(kind, Q)
    lanes = crafted_lanes(rng, 12, shape, Q, fov, deltas, max(max_iters, 4))
    # Lanes in the oracle case see an image that leads somewhere.
    image = np.where(rng.rand(*shape) < 0.7, 1.0, -1.0).astype(np.float32) \
        if kind == "oracle" else rng.randn(*shape).astype(np.float32)
    blocked = lanes["blocked"][0]
    jstate, pstate = _lane_states(lanes)
    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jblk, pblk = jeng.put_blocked(blocked), peng.put_blocked(blocked)
    exact = kind == "oracle"
    executed = 0
    for _ in range(3):
        jstate, jaux = jeng.run_hops(jimg, jblk, jstate, hops, max_iters)
        pstate, paux = peng.run_hops(pimg, pblk, pstate, hops, max_iters)
        _compare(jstate, pstate, exact)
        assert set(paux) == set(jaux)
        for key in jaux:
            np.testing.assert_array_equal(paux[key], jaux[key], err_msg=key)
        executed += int(paux["executed"].sum())
    statuses = set(np.asarray(jstate.status).tolist())
    assert executed > 0 and hop_engine.DONE_EMPTY in statuses
    if Q == 16:
        assert hop_engine.STALLED_FULL in statuses
    if Q == 64 and kind == "oracle":
        for name in ("skip_threshold", "skip_invalid", "skip_restricted"):
            assert np.asarray(getattr(jstate, name)).max() > 16, name


@pytest.mark.parametrize("deltas", [(2, 2, 2), (3, 0, 2), (0, 1, 3)])
def test_face_moves_match_jax(deltas):
    # Face maxima, the lexsort and the duplicate drop (hop_engine.py:998-1009)
    # on patches with tied maxima and zero-delta axes.
    rng = np.random.RandomState(4)
    kw = dict(fov_size=[9] * 3, deltas=list(deltas[::-1]))
    jeng = jax_hop.HopEngine(jax_oracle.ThresholdOracleModel(**kw), {},
                             pad_value=PAD, move_threshold=MOVE_T,
                             disco_seed_threshold=0.0)
    peng = hop_engine.HopEngine(oracle.ThresholdOracleModel(**kw),
                                pad_value=PAD, move_threshold=MOVE_T,
                                disco_seed_threshold=0.0, device="cpu")
    patches = tied_logits(rng, 12, 9)
    patches[3] = 5.0                      # every face tied everywhere
    patches[5, 4] = 2.0                   # z faces tie with each other
    got = hop_ops.sorted_pushes(*hop_ops.face_scores_plain(
        torch.from_numpy(patches), deltas), MOVE_T)
    for i, patch in enumerate(patches):
        scores, offsets = jeng._face_scores(jnp.asarray(patch))
        pscores, poffsets = peng._face_scores(torch.from_numpy(patch))
        np.testing.assert_array_equal(pscores.numpy(), np.asarray(scores))
        np.testing.assert_array_equal(poffsets.numpy(), np.asarray(offsets))
        keep = scores >= MOVE_T
        order = jnp.lexsort((-offsets[:, 2], -offsets[:, 1], -offsets[:, 0],
                             -scores))
        scores, offsets, keep = scores[order], offsets[order], keep[order]
        dup = jnp.concatenate([jnp.zeros((1,), bool),
                               (scores[1:] == scores[:-1])
                               & jnp.all(offsets[1:] == offsets[:-1], axis=1)])
        for g, w in zip(got, (scores, offsets, keep & ~dup)):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_lane_reads_match_jax():
    # lane_verdicts, lane_mask_region and lane_seed_region (K7's plain
    # versions and the bucketed boxes), set_lane_seed_region and
    # compact_lanes against the JAX engine.
    rng = np.random.RandomState(8)
    jeng, peng = _engines("oracle", 32)
    shape = (70, 72, 74)
    lanes = crafted_lanes(rng, 10, shape, 32, 9, (2, 3, 2), 4)
    blocked = lanes["blocked"][0]
    jstate, pstate = _lane_states(lanes)
    seg_t = float(np.float32(np.log(0.6 / 0.4)))
    got = peng.lane_verdicts(pstate, peng.put_blocked(blocked), seg_t, MOVE_T)
    want = jeng.lane_verdicts(jstate, jeng.put_blocked(blocked), seg_t,
                              MOVE_T)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int64 and (~got[1]).any() and got[1].any()
    for lane, start, size in ((0, (3, 4, 5), (10, 70, 2)),
                              (9, (60, 63, 61), (9, 7, 9)),
                              (2, (-3, 0, 0), (80, 80, 80))):
        origin = lanes["start"][lane]
        g = peng.lane_mask_region(pstate.seeds, lane, start, size, seg_t,
                                  origin)
        w = jeng.lane_mask_region(jstate.seeds, lane, start, size, seg_t,
                                  origin)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]
        g = peng.lane_seed_region(pstate.seeds, lane, start, size)
        w = jeng.lane_seed_region(jstate.seeds, lane, start, size)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])

    region = rng.randn(9, 7, 9).astype(np.float32)
    pseeds = peng.set_lane_seed_region(pstate.seeds, 1, (60, 63, 61), region)
    jseeds = jeng.set_lane_seed_region(jstate.seeds, 1, (60, 63, 61), region)
    np.testing.assert_array_equal(pseeds.numpy(), np.asarray(jseeds))

    keep = [9, 0, 0, 2]
    got = peng.compact_lanes(pstate, keep)
    # The JAX engine donated the old seeds to set_lane_seed_region.
    want = jeng.compact_lanes(dataclasses.replace(jstate, seeds=jseeds), keep)
    _compare(want, got, exact=True)
    assert got.seeds.data_ptr() != pstate.seeds.data_ptr()


def test_update_blocked_region_upper_face():
    # The JAX test_hop_overflow_restrictor.py:19 case on the port, held to
    # the JAX engine's result: a clamped bucket must not displace the region.
    jeng, peng = _engines("oracle", 32)
    shape = (70, 72, 74)
    region = (np.arange(5 * 7 * 9).reshape(5, 7, 9) % 2).astype(np.uint8)
    pblk = peng.put_blocked(np.zeros(shape, np.uint8))
    jblk = jeng.put_blocked(np.zeros(shape, np.uint8))
    for start in ((65, 63, 61), (3, 4, 5)):
        pblk = peng.update_blocked_region(pblk, start, region)
        jblk = jeng.update_blocked_region(jblk, start, region)
    np.testing.assert_array_equal(pblk.numpy(), np.asarray(jblk))
    expect = np.zeros(shape, np.uint8)
    expect[65:70, 63:70, 61:70] = region
    expect[3:8, 4:11, 5:14] |= region
    np.testing.assert_array_equal(pblk.numpy(), expect)


@pytest.mark.parametrize("kind", ["oracle", "convstack"])
def test_screen_seeds_matches_jax(kind):
    rng = np.random.RandomState(12)
    jeng, peng = _engines(kind, 32)
    fov = 9 if kind == "oracle" else 17
    shape = (30, 31, 32)
    image = rng.randn(*shape).astype(np.float32)
    if kind == "oracle":
        image = np.where(image > 0.3, 1.0, -1.0).astype(np.float32)
    # 300 candidates: one batch of 256 and one padded to 64.
    pos = rng.randint(fov // 2, np.array(shape) - fov // 2, size=(300, 3))
    # A negative init activation lets the disco mask keep the old origin.
    verdicts = []
    for init in (float(np.log(0.95 / 0.05)), -0.5):
        got = peng.screen_seeds(peng.put_image(image), pos, init)
        want = jeng.screen_seeds(jeng.put_image(image), pos, init)
        np.testing.assert_array_equal(got, want)
        verdicts.append(got)
    assert verdicts[0].any() and (verdicts[0] != verdicts[1]).any()
    if kind == "oracle":
        assert (~verdicts[0]).any()


def test_port_refuses_what_it_does_not_run():
    jeng, peng = _engines("oracle", 32)
    state = peng.init_lane_state(2, (20, 20, 20))
    img = peng.put_image(np.zeros((20, 20, 20), np.float32))
    blk = peng.put_blocked(np.zeros((20, 20, 20), np.uint8))
    # Device finalization and sync=False are ported, on bfloat16 seeds too;
    # what stays refused is what the JAX engine refuses too, and float16
    # seeds, which the JAX Runner never picks.
    with pytest.raises(ValueError, match="needs fin_opts"):
        peng.run_hops(img, blk, state, 2,
                      fstate=peng.init_finalize_state(1, 2, (20, 20, 20)))
    with pytest.raises(ValueError, match="<= 17 slots"):
        peng.init_finalize_state(18, 2, (20, 20, 20))
    _, packed = peng.run_hops(img, blk, state, 2, sync=False)
    assert isinstance(packed, torch.Tensor) and packed.shape == (2, 19)
    beng = hop_engine.HopEngine(peng.model, pad_value=PAD,
                                move_threshold=MOVE_T,
                                disco_seed_threshold=0.0, device="cpu",
                                seed_dtype=torch.bfloat16)
    bstate = beng.init_lane_state(2, (20, 20, 20))
    assert bstate.seeds.dtype == torch.bfloat16
    fstate = beng.init_finalize_state(1, 2, (20, 20, 20))
    bstate, fstate, _ = beng.run_hops(img, blk, bstate, 2, fstate=fstate,
                                      fin_opts=[0.4, 5, 2.0])
    assert bstate.seeds.dtype == torch.bfloat16 and int(fstate.log_n) == 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        hop_engine.HopEngine(peng.model, pad_value=PAD, move_threshold=MOVE_T,
                             disco_seed_threshold=0.0, device="cpu",
                             seed_dtype=torch.float16)
