"""ffn_tpu_torch's device finalization (plain path) against the JAX
package's: test_torch_kernels.crafted_finalize's state (every K8 branch)
through both engines' run_hops(fstate=...) for 1-3 hops; with the oracle
every field bit for bit, with the CI ConvStack seeds within 1e-5 (same
NaN pattern) and the rest exact. Also the FIFO load, the slot
segmentation reset and download, the slot stacks and unpack_round.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import hop_engine as jax_hop
from ffn_tpu_torch.inference import hop_engine
from test_torch_hop_engine import _engines
from test_torch_kernels import crafted_finalize

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

LANE_FIELDS = list(jax_hop.LaneState.__dataclass_fields__)
FIN_FIELDS = list(jax_hop.FinalizeState.__dataclass_fields__)
CASES = {   # kind -> (shape, fov, deltas, max_iters, min_size)
    "oracle": ((20, 22, 24), 9, (2, 3, 2), 5, 20),
    "convstack": ((28, 30, 32), 17, (6, 6, 6), 4, 20),
}


def _jax_states(lanes, fin):
    js = jax_hop.LaneState(**{k: jnp.asarray(lanes[k]) for k in LANE_FIELDS})
    jf = jax_hop.FinalizeState(**{k: jnp.asarray(fin[k])
                                  for k in FIN_FIELDS})
    return js, jf


def _port_states(lanes, fin):
    def t(a):
        return torch.from_numpy(np.array(a))
    return (hop_engine.LaneState(**{k: t(lanes[k]) for k in LANE_FIELDS}),
            hop_engine.FinalizeState(**{k: t(fin[k]) for k in FIN_FIELDS}))


def _inputs(kind):
    shape, fov, deltas, max_iters, min_size = CASES[kind]
    rng = np.random.RandomState(21)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, shape, 64, 24, fov, deltas, max_iters, min_size)
    image = rng.randn(2, *shape).astype(np.float32)
    shapes = np.array([shape, (shape[0] - 2, shape[1], shape[2] - 1)],
                      np.int32)
    return lanes, fin, blocked, opts, image, shapes, max_iters


_ENGINES = {}


def _engine_pair(kind):
    if kind not in _ENGINES:
        _ENGINES[kind] = _engines(kind, 64)
    return _ENGINES[kind]


@pytest.fixture(scope="module")
def jax_rounds():
    """JAX's run_hops(fstate=...) on each case for 1, 2 and 3 hops: (packed,
    lane state, finalize state) as numpy."""
    out = {}
    for kind in CASES:
        jeng, _ = _engine_pair(kind)
        lanes, fin, blocked, opts, image, shapes, max_iters = _inputs(kind)
        for hops in (1, 2, 3):
            js, jf = _jax_states(lanes, fin)
            js, jf, packed = jeng.run_hops(
                jnp.asarray(image), jnp.asarray(blocked), js, hops,
                max_iters, shapes=shapes, sync=False, fstate=jf,
                fin_opts=opts)
            out[kind, hops] = (
                np.asarray(packed),
                {k: np.asarray(getattr(js, k)) for k in LANE_FIELDS},
                {k: np.asarray(getattr(jf, k)) for k in FIN_FIELDS})
    return out


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_run_hops_device_finalize_matches_jax(jax_rounds, kind, hops):
    _, peng = _engine_pair(kind)
    lanes, fin, blocked, opts, image, shapes, max_iters = _inputs(kind)
    ps, pf = _port_states(lanes, fin)
    ps, pf, packed = peng.run_hops(
        torch.from_numpy(image), torch.from_numpy(blocked), ps, hops,
        max_iters, shapes=shapes, sync=False, fstate=pf, fin_opts=opts)
    want_packed, want_lanes, want_fin = jax_rounds[kind, hops]
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    for name in LANE_FIELDS:
        got, want = getattr(ps, name).numpy(), want_lanes[name]
        if kind == "convstack" and name in ("seeds", "qscore"):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in FIN_FIELDS:
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      want_fin[name], err_msg=name)
    aux, rows, head, claimed = peng.unpack_round(packed, 24, 2)
    jaux, jrows, jhead, jclaimed = jax_hop.HopEngine.unpack_round(
        want_packed, 24, 2)
    assert head == jhead and len(rows) >= 10
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(claimed, jclaimed)
    for key in jaux:
        np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
    if hops == 1:   # every outcome code in one round
        assert set(rows[:, 8].tolist()) == {1, 2, 3, 4, 5}


def test_sync_round_and_drain_log_match_jax(jax_rounds):
    jeng, peng = _engine_pair("oracle")
    lanes, fin, blocked, opts, image, shapes, max_iters = _inputs("oracle")
    ps, pf = _port_states(lanes, fin)
    ps, pf, aux = peng.run_hops(
        torch.from_numpy(image), torch.from_numpy(blocked), ps, 2,
        max_iters, shapes=shapes, fstate=pf, fin_opts=opts)
    js, jf = _jax_states(lanes, fin)
    js, jf, jaux = jeng.run_hops(
        jnp.asarray(image), jnp.asarray(blocked), js, 2, max_iters,
        shapes=shapes, fstate=jf, fin_opts=opts)
    for key in jaux:
        np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
    for got, want in zip(peng.drain_log(pf), jeng.drain_log(jf)):
        np.testing.assert_array_equal(got, want)


def test_round_nothing_alive_runs_no_hop():
    # JAX checks its loop cond before the first hop: with no lane running,
    # finishable or refillable, the round leaves the state untouched.
    jeng, peng = _engine_pair("oracle")
    lanes, fin, blocked, opts, image, shapes, max_iters = _inputs("oracle")
    lanes["status"][:] = 5   # every lane STALLED_FULL: host work only
    ps, pf = _port_states(lanes, fin)
    before = ps.seeds.clone()
    ps, pf, packed = peng.run_hops(
        torch.from_numpy(image), torch.from_numpy(blocked), ps, 3,
        max_iters, shapes=shapes, sync=False, fstate=pf, fin_opts=opts)
    js, jf = _jax_states(lanes, fin)
    _, _, jpacked = jeng.run_hops(
        jnp.asarray(image), jnp.asarray(blocked), js, 3, max_iters,
        shapes=shapes, sync=False, fstate=jf, fin_opts=opts)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert torch.equal(torch.nan_to_num(ps.seeds, 7.0),
                       torch.nan_to_num(before, 7.0))
    assert int(pf.log_n) == 0 and int(pf.fifo_head) == 0


def test_slot_programs_match_jax():
    jeng, peng = _engine_pair("oracle")
    rng = np.random.RandomState(5)
    shape = (12, 10, 14)
    jf = jeng.init_finalize_state(3, 6, shape, fifo_capacity=16)
    pf = peng.init_finalize_state(3, 6, shape, fifo_capacity=16)
    for name in FIN_FIELDS:
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jf, name)), name)
    pos = rng.randint(0, 10, size=(5, 3)).astype(np.int32)
    sv = np.array([0, 2, 1, 2, 0], np.int32)
    hold = rng.rand(6) < 0.5
    seg = rng.randint(0, 4, size=(3,) + shape).astype(np.int32)
    jf = jax_hop.FinalizeState(**{
        **{k: getattr(jf, k) for k in FIN_FIELDS}, "seg": jnp.asarray(seg),
        "claimed": jnp.asarray([3, 1, 2], jnp.int32),
        "log_n": jnp.int32(4)})
    pf.seg.copy_(torch.from_numpy(seg))
    pf.claimed.copy_(torch.tensor([3, 1, 2], dtype=torch.int32))
    pf.log_n.fill_(4)
    jf = jeng.round_prep(jf, pos, sv, hold)
    pf = peng.round_prep(pf, pos, sv, hold)
    jf = jeng.reset_slot_seg(jf, 1, next_sid=7)
    pf = peng.reset_slot_seg(pf, 1, next_sid=7)
    for name in FIN_FIELDS:
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jf, name)), name)
    for slot, size in ((0, shape), (2, (11, 9, 13)), (1, (5, 10, 1))):
        np.testing.assert_array_equal(
            peng.download_slot_seg(pf, slot, size),
            jeng.download_slot_seg(jf, slot, size))
        np.testing.assert_array_equal(
            peng.slice_slot_seg(pf, slot, size).numpy(),
            np.asarray(jeng.slice_slot_seg(jf, slot, size)))
    with pytest.raises(ValueError, match="fifo overflow"):
        peng.round_prep(pf, np.zeros((17, 3), np.int32),
                        np.zeros(17, np.int32), hold)

    # Slot stacks: None slots and smaller volumes padded with the fill.
    vols = [rng.randn(*shape).astype(np.float32), None,
            rng.randn(12, 7, 9).astype(np.float32)]
    for dtype, fill in ((np.float32, 0.0), (np.uint8, 1)):
        arrays = [None if v is None else (v > 0).astype(dtype)
                  if dtype == np.uint8 else v for v in vols]
        jstack = jeng.put_stack(arrays, shape, dtype, fill=fill)
        pstack = peng.put_stack(arrays, shape, dtype, fill=fill)
        np.testing.assert_array_equal(pstack.numpy(), np.asarray(jstack))
        new = (rng.rand(9, 10, 3) * 5).astype(dtype)
        jstack = jeng.update_stack_slot(jstack, 1, new, fill=fill)
        pstack = peng.update_stack_slot(pstack, 1, new, fill=fill)
        np.testing.assert_array_equal(pstack.numpy(), np.asarray(jstack))
        full = np.full(shape, 3, dtype)
        jstack = jeng.update_stack_slot(jstack, 0, jnp.asarray(full))
        pstack = peng.update_stack_slot(pstack, 0, torch.from_numpy(full))
        np.testing.assert_array_equal(pstack.numpy(), np.asarray(jstack))


def test_screen_seeds_async_matches_screen_seeds():
    jeng, peng = _engine_pair("convstack")
    rng = np.random.RandomState(8)
    image = rng.randn(2, 28, 30, 32).astype(np.float32)
    pos = rng.randint(8, 20, size=(70, 3)).astype(np.int32)
    sv = rng.randint(0, 2, size=70).astype(np.int32)
    strong = peng.screen_seeds_async(torch.from_numpy(image), pos, 2.9,
                                     sv=sv)
    assert strong.shape == (256,)
    want = jeng.screen_seeds(jnp.asarray(image), pos, 2.9, sv=sv)
    np.testing.assert_array_equal(strong.numpy()[:70], want)
    with pytest.raises(ValueError, match="1..256"):
        peng.screen_seeds_async(torch.from_numpy(image),
                                np.zeros((0, 3), np.int32), 2.9)
