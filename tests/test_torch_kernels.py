"""ffn_tpu_torch's CUDA kernels against their plain PyTorch versions. The
`cuda` tests need an NVIDIA card and skip without one; on the card:

  python -m pytest tests/test_torch_kernels.py -q

Imports torch and the port only. K1 within 1e-4 of max|plain| (another
float32 order, TF32 off); K15 within one ulp of its type per rounding
(k15_tolerance), at most DIFFER_SHARE differing; the data-moving kernels
and the int8 ones (K19, K20) bit for bit.
"""

import numpy as np
import pytest
import torch

from ffn_tpu_torch.ops import conv3d
from ffn_tpu_torch.ops.conv3d_bf16_check import (DIFFER_SHARE, K15_CASES,
                                                 conv3d_ndhwc_bf16_exact,
                                                 differ_share, k15_inputs,
                                                 k15_tolerance, k17_tolerance)
from ffn_tpu_torch.ops import step as step_ops

FOV = 9
PAD = float(np.log(0.05 / 0.95))
MOVE_T = float(np.log(0.9 / 0.1))
SHAPE = (20, 22, 24)
# Interior steps and two near faces, where the start wraps and clamps.
POSITIONS = [(10, 11, 12), (12, 13, 10), (2, 3, 21), (18, 20, 1)]

# Every flag combination of the stack: conv0_a, conv0_b, a block's _a and
# _b, and conv_lom, at the full width (32 features).
K1_CASES = {
    "conv0_a": (3, 2, 32, False, True, False),
    "conv0_b": (3, 32, 32, False, False, False),
    "block_a": (3, 32, 32, True, True, False),
    "block_b": (3, 32, 32, False, False, True),
    "conv_lom": (1, 32, 1, True, False, True),
    "odd_widths": (3, 13, 40, True, True, True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_k1_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 4, 2)
    with pytest.raises(ValueError):
        conv3d.conv3d_ndhwc_f32(x, torch.zeros(3, 3, 3, 3, 8),
                                torch.zeros(8))
    with pytest.raises(ValueError):
        conv3d.conv3d_ndhwc_f32(x, torch.zeros(2, 2, 2, 2, 8),
                                torch.zeros(8))
    with pytest.raises(TypeError):
        conv3d.conv3d_ndhwc_f32(x.double(), torch.zeros(3, 3, 3, 2, 8),
                                torch.zeros(8))


def test_step_kernels_reject_bad_inputs():
    vol = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        step_ops.step_gather(vol, torch.zeros(5, 5, 5), (3, 3, 3),
                             (3, 3, 3), (3, 3, 3), PAD)
    with pytest.raises(ValueError):
        step_ops.step_update(torch.zeros(40, 3, 3), vol, (3, 3, 3),
                             (3, 3, 3), MOVE_T, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_kernel_matches_plain(card, case):
    k, cin, cout, pre, post, res = K1_CASES[case]
    gen = torch.Generator().manual_seed(0)
    shape = (2, 9, 10, 11)
    x = torch.randn(*shape, cin, generator=gen).to(card)
    w = (torch.randn(k, k, k, cin, cout, generator=gen) * 0.2).to(card)
    b = torch.randn(cout, generator=gen).to(card)
    r = torch.randn(*shape, cout, generator=gen).to(card) if res else None
    got = conv3d.conv3d_ndhwc_f32(x, w, b, pre_relu=pre, post_relu=post,
                                  residual=r)
    want = conv3d.conv3d_ndhwc_plain(x, w, b, pre_relu=pre, post_relu=post,
                                     residual=r)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4 * float(want.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 64, 256])
def test_k1_kernel_matches_plain_at_hop_batches(card, n):
    # The hop path's shapes: the 64-lane conv buckets and a screen batch
    # of 256, on the 33^3 FOV at the full width.
    gen = torch.Generator(device=card).manual_seed(n)
    for case in ("conv0_a", "block_a", "block_b", "conv_lom"):
        k, cin, cout, pre, post, res = K1_CASES[case]
        shape = (n, 33, 33, 33)
        x = torch.randn(*shape, cin, generator=gen, device=card)
        w = torch.randn(k, k, k, cin, cout, generator=gen, device=card) * 0.1
        b = torch.randn(cout, generator=gen, device=card)
        r = torch.randn(*shape, cout, generator=gen, device=card) \
            if res else None
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        got = conv3d.conv3d_ndhwc_f32(x, w, b, **kw)
        want = conv3d.conv3d_ndhwc_plain(x, w, b, **kw)
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (case, err)


def test_k15_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 4, 2)
    w = torch.zeros(3, 3, 3, 2, 8, dtype=torch.bfloat16)
    b = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):      # float32 weights
        conv3d.conv3d_ndhwc_bf16(x, w.float(), b)
    with pytest.raises(TypeError):      # a float64 input
        conv3d.conv3d_ndhwc_bf16(x.double(), w, b)
    with pytest.raises(ValueError):     # channel mismatch
        conv3d.conv3d_ndhwc_bf16(x, torch.zeros(3, 3, 3, 3, 8,
                                                dtype=torch.bfloat16), b)
    with pytest.raises(ValueError):     # a residual of the wrong shape
        conv3d.conv3d_ndhwc_bf16(x, w, b, residual=torch.zeros(1, 4, 4, 4,
                                                                4))
    # The plain version's output types: bfloat16, or float32 under a
    # float32 residual.
    assert conv3d.conv3d_ndhwc_bf16(x, w, b).dtype == torch.bfloat16
    assert conv3d.conv3d_ndhwc_bf16(
        x, w, b, residual=torch.zeros(1, 4, 4, 4, 8)).dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K15_CASES))
@pytest.mark.parametrize("n", [1, 8, 64])
def test_k15_kernel_matches_plain(card, case, n):
    k, _, _, pre, post, _, _ = K15_CASES[case]
    gen = torch.Generator(device=card).manual_seed(n)
    x, w, b, r = k15_inputs(gen, n, (33, 33, 33), case)
    kw = dict(pre_relu=pre, post_relu=post, residual=r)
    got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
    want = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs() / k15_tolerance(x, w, b, **kw)
    assert float(err.max()) <= 1.0, (case, float(err.max()))
    assert differ_share(got, want) <= DIFFER_SHARE, (
        case, differ_share(got, want))
    # K15 rounds as the exact sum would.
    assert torch.equal(got, conv3d_ndhwc_bf16_exact(x, w, b, **kw)), case
    # Deterministic, and a sample does not depend on the batch around it.
    assert torch.equal(got, conv3d.conv3d_ndhwc_bf16(x, w, b, **kw))
    i = n // 2
    one = conv3d.conv3d_ndhwc_bf16(
        x[i:i + 1].clone(), w, b, pre_relu=pre, post_relu=post,
        residual=None if r is None else r[i:i + 1].clone())
    assert torch.equal(one[0], got[i])


@pytest.mark.parametrize("case", list(K15_CASES))
def test_k15_exact_version_matches_plain(case):
    # The float64 sums' rounding, K15's function on the card, is one more
    # float32 order for the plain version's limits.
    _, _, _, pre, post, _, _ = K15_CASES[case]
    gen = torch.Generator().manual_seed(sorted(K15_CASES).index(case))
    x, w, b, r = k15_inputs(gen, 3, (9, 10, 11), case)
    kw = dict(pre_relu=pre, post_relu=post, residual=r)
    got = conv3d_ndhwc_bf16_exact(x, w, b, **kw)
    want = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs() / k15_tolerance(x, w, b, **kw)
    assert float(err.max()) <= 1.0, (case, float(err.max()))
    assert differ_share(got, want) <= DIFFER_SHARE, case
    # Sample by sample as in one batch.
    one = conv3d_ndhwc_bf16_exact(
        x[1:2], w, b, pre_relu=pre, post_relu=post,
        residual=None if r is None else r[1:2])
    assert torch.equal(one[0], got[1])


@pytest.mark.cuda
def test_k15_kernel_takes_odd_volumes(card):
    # Partial tiles on every face: 9 x 10 x 11 is no multiple of 4 x 4 x 8.
    gen = torch.Generator(device=card).manual_seed(3)
    for case in ("conv0_a", "block_b", "conv_lom"):
        k, _, _, pre, post, _, _ = K15_CASES[case]
        x, w, b, r = k15_inputs(gen, 2, (9, 10, 11), case)
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
        want = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
        err = (got.float() - want.float()).abs() / k15_tolerance(x, w, b,
                                                                 **kw)
        assert float(err.max()) <= 1.0, (case, float(err.max()))
        assert torch.equal(got, conv3d_ndhwc_bf16_exact(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("disco", [-1.0, 0.0, 0.5, 0.99])
def test_step_kernels_match_plain(card, disco):
    rng = np.random.RandomState(6)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(card)
    seed_np = (rng.randn(*SHAPE) * 3).astype(np.float32)
    seed_np[rng.rand(*SHAPE) < 0.3] = np.nan
    for pos in POSITIONS:
        seed = torch.from_numpy(seed_np).to(card)
        got = step_ops.step_gather(image, seed, pos, (FOV,) * 3, (7, 7, 7),
                                   PAD)
        want = step_ops.step_gather_plain(image, seed, pos, (FOV,) * 3,
                                          (7, 7, 7), PAD)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())

        logits = torch.from_numpy(
            (rng.randn(FOV, FOV, FOV) * 3).astype(np.float32)).to(card)
        pseed = seed.clone()
        kpatch = step_ops.step_update(logits, seed, pos, (7, 7, 7), MOVE_T,
                                      disco)
        ppatch = step_ops.step_update_plain(logits, pseed, pos, (7, 7, 7),
                                            MOVE_T, disco)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(kpatch.cpu().numpy(),
                                      ppatch.cpu().numpy())
        np.testing.assert_array_equal(seed.cpu().numpy(),
                                      pseed.cpu().numpy())


# -- K4-K7: the hop path's kernels ---------------------------------------------

MOVE_T_F32 = float(np.float32(MOVE_T))


def grid_geometry(shape, deltas):
    """HopEngine.grid_geometry: dedup-grid shape and offset."""
    d = np.maximum(np.array(deltas), 1)
    span = np.ceil(np.array(shape) / d).astype(int)
    return tuple(int(g) for g in 2 * span + 3), tuple(int(o) for o in span + 1)


def crafted_lanes(rng, B, shape, Q, fov, deltas, max_iters):
    """A LaneState (numpy) that drives every branch of K4 and K6: NaN and weak
    seeds, fresh, capped, idle and nearly full lanes, and queues whose live
    range opens with a run of more than 16 stale entries of one kind
    (out of bounds, claimed, restricted, visited cell, weak seed) before a
    valid one."""
    margin = fov // 2
    grid, off = grid_geometry(shape, deltas)
    hi = np.array(shape) - margin
    seeds = (rng.randn(B, *shape) * 3).astype(np.float32)
    seeds[rng.rand(B, *shape) < 0.3] = np.nan
    blocked = np.zeros(shape, np.uint8)
    blocked[rng.rand(*shape) < 0.05] = 1
    blocked[rng.rand(*shape) < 0.05] |= 2
    done = (rng.rand(B, *grid) < 0.05).astype(np.uint8)
    start = rng.randint(margin, hi, size=(B, 3)).astype(np.int32)
    for b, s in enumerate(start):
        seeds[(b,) + tuple(s)] = 4.0
    qpos = rng.randint(margin - 3, hi + 3, size=(B, Q, 3)).astype(np.int32)
    qscore = rng.rand(B, Q).astype(np.float32)
    head = rng.randint(0, 3 * Q, size=B).astype(np.int32)
    tail = head + rng.randint(0, Q - 6, size=B).astype(np.int32)
    status = np.where(rng.rand(B) < 0.85, 1, rng.randint(0, 6, size=B))
    fresh = rng.rand(B) < 0.15
    iters = rng.randint(0, max_iters, size=B).astype(np.int32)
    lane = iter(range(B))
    used = set()
    for kind in ("bounds", "claimed", "restricted", "done", "weak")[
            :5 if Q >= 30 else 0]:
        b = next(lane)
        status[b], fresh[b] = 1, False
        tail[b] = head[b] + 24
        for i in range(20):
            slot = (head[b] + i) % Q
            p = rng.randint(margin, hi).astype(np.int32)
            while tuple(p) in used:
                p = rng.randint(margin, hi).astype(np.int32)
            used.add(tuple(p))
            # Exactly one reason to skip each entry.
            cell = (p - start[b] + np.maximum(deltas, 1) // 2) \
                // np.maximum(deltas, 1) + off
            done[(b,) + tuple(cell)] = kind == "done"
            blocked[tuple(p)] = {"claimed": 1, "restricted": 2}.get(kind, 0)
            seeds[(b,) + tuple(p)] = 4.0
            if kind == "bounds":
                p[i % 3] = margin - 1 - i % 2
            elif kind == "weak":
                seeds[(b,) + tuple(p)] = np.nan if i % 2 else -1.0
            qpos[b, slot] = p
    b = next(lane)                     # weak origin: NaN, not fresh
    status[b], fresh[b], iters[b] = 1, False, 0
    seeds[(b,) + tuple(start[b])] = np.nan
    b = next(lane)                     # capped
    status[b], iters[b] = 1, max_iters
    b = next(lane)                     # nearly full: stalls
    status[b], fresh[b], iters[b] = 1, False, 0
    tail[b] = head[b] + Q - 5
    b = next(lane)                     # exactly at the stall limit: runs
    status[b], fresh[b], iters[b] = 1, True, 0
    tail[b] = head[b] + Q - 6
    b = next(lane)                     # fresh with an empty queue
    status[b], fresh[b], tail[b] = 1, True, head[b]
    z = np.zeros(B, np.int32)
    return dict(
        blocked=blocked[None], shapes=np.array([shape], np.int32),
        seeds=seeds, sv=z.copy(), qpos=qpos, qscore=qscore, head=head,
        tail=tail, done=done, start=start, minp=start.copy(),
        maxp=start.copy(), iters=iters, status=status.astype(np.int32),
        fresh=fresh, overflow=z.copy(), skip_threshold=z.copy(),
        skip_invalid=z.copy(), skip_restricted=z.copy(),
        executed=z.copy(), pops=z.copy())


def tied_logits(rng, n, fov, scale=3.0):
    """Model outputs whose face planes hold runs of equal maxima."""
    lg = (rng.randn(n, fov, fov, fov) * scale).astype(np.float32)
    c = fov // 2
    lg[:, :, c, :] = np.round(lg[:, :, c, :])     # ties on the y faces
    lg[::2, c - 2, 1:-1, 1:-1] = 7.0             # a flat z face
    lg[1::3, :, :, c + 1] = 9.0                   # equal x-face maxima
    return lg


def hop_step(ops, state, logits, *, fov, pred, deltas, max_iters, disco):
    """K4 -> K5 -> K6 on torch tensors (through `ops`, the kernels or their
    plain versions); returns (pos, execute, order, summary, img, seed_in,
    patch)."""
    s = state
    grid_off = grid_geometry(s["seeds"].shape[1:], deltas)[1]
    pos, execute, order, summary = ops.hop_pop(
        s["blocked"], s["shapes"], s["seeds"], s["sv"], s["qpos"],
        s["head"], s["tail"], s["done"], s["start"], s["iters"],
        s["status"], s["fresh"], s["skip_threshold"], s["skip_invalid"],
        s["skip_restricted"], s["executed"], s["pops"],
        move_threshold=MOVE_T, margin=(fov // 2,) * 3, deltas=deltas,
        grid_offset=grid_off, max_iters=max_iters)
    n_exec = int(summary[0])
    img, seed_in = ops.hop_gather(
        s["image"], pos, s["sv"], order, s["seeds"], image_size=(fov,) * 3,
        seed_size=(fov,) * 3, pad=PAD)
    patch = ops.hop_update(
        logits[:n_exec].contiguous(), s["seeds"], pos, execute,
        order[:n_exec], s["start"], s["done"], s["minp"], s["maxp"],
        s["iters"], s["fresh"], s["qpos"], s["qscore"], s["head"],
        s["tail"], s["overflow"], pred_size=(pred,) * 3, deltas=deltas,
        grid_offset=grid_off, move_threshold=MOVE_T, disco_threshold=disco)
    return pos, execute, order, summary, img, seed_in, patch


def to_torch(arrays, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def assert_same(got, want):
    for name in want:
        g, w = got[name], want[name]
        if torch.is_tensor(w):
            g, w = g.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


class _PlainHop:
    from ffn_tpu_torch.ops.hop import (hop_gather_plain as hop_gather,
                                       hop_pop_plain as hop_pop,
                                       hop_update_plain as hop_update)


@pytest.mark.cuda
@pytest.mark.parametrize("deltas,pred,disco", [
    ((2, 2, 2), 9, 0.0), ((3, 0, 2), 7, -1.0), ((2, 3, 1), 9, 0.99)])
def test_hop_kernels_match_plain(card, deltas, pred, disco):
    from ffn_tpu_torch.ops import hop as hop_ops
    rng = np.random.RandomState(9)
    B, Q, fov, max_iters = 37, 64, 9, 5
    lanes = crafted_lanes(rng, B, SHAPE, Q, fov, deltas, max_iters)
    lanes["image"] = rng.randn(1, *SHAPE).astype(np.float32)
    logits = tied_logits(rng, B, fov)
    logits[3, 4, 4, 1] = np.nan
    ks, ps = to_torch(lanes, card), to_torch(lanes, card)
    lg = torch.from_numpy(logits).to(card)
    for hop in range(3):   # the state evolves: later hops pop pushes
        got = hop_step(hop_ops, ks, lg, fov=fov, pred=pred, deltas=deltas,
                       max_iters=max_iters, disco=disco)
        want = hop_step(_PlainHop, ps, lg, fov=fov, pred=pred, deltas=deltas,
                        max_iters=max_iters, disco=disco)
        torch.cuda.synchronize()
        n_exec = int(want[3][0])
        assert n_exec > 0
        for g, w in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        np.testing.assert_array_equal(got[6][:n_exec].cpu().numpy(),
                                      want[6][:n_exec].cpu().numpy())
        assert_same(ks, ps)
    skips = ps["skip_threshold"] + ps["skip_invalid"] + ps["skip_restricted"]
    assert (ps["skip_threshold"] > 16).any() and (ps["skip_invalid"] > 16
                                                  ).any()
    assert (ps["skip_restricted"] > 16).any() and (skips >= 0).all()


@pytest.mark.cuda
def test_hop_screen_matches_plain(card):
    from ffn_tpu_torch.ops import hop as hop_ops
    rng = np.random.RandomState(3)
    image = torch.from_numpy(rng.randn(1, *SHAPE).astype(np.float32)).to(card)
    pos = torch.from_numpy(rng.randint(0, 20, size=(40, 3)).astype(
        np.int32)).to(card)
    sv = torch.zeros(40, dtype=torch.int32, device=card)
    got = hop_ops.hop_gather(image, pos, sv, None, None, image_size=(FOV,) * 3,
                             seed_size=(FOV,) * 3, pad=PAD,
                             init_activation=2.9)
    want = hop_ops.hop_gather_plain(image, pos, sv, None, None,
                                    image_size=(FOV,) * 3,
                                    seed_size=(FOV,) * 3, pad=PAD,
                                    init_activation=2.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    logits = torch.from_numpy(tied_logits(rng, 40, FOV)).to(card)
    for disco, init in ((0.0, 2.9), (-1.0, 2.9), (0.0, -0.5), (0.3, -0.5)):
        kw = dict(pred_size=(7, 7, 7), move_threshold=MOVE_T,
                  disco_threshold=disco, init_activation=init)
        np.testing.assert_array_equal(
            hop_ops.hop_screen(logits, **kw).cpu().numpy(),
            hop_ops.hop_screen_plain(logits, **kw).cpu().numpy())


@pytest.mark.cuda
def test_lane_threshold_matches_plain(card):
    from ffn_tpu_torch.ops import lane as lane_ops
    rng = np.random.RandomState(5)
    B = 70
    seeds = (rng.randn(B, *SHAPE) * 3).astype(np.float32)
    seeds[rng.rand(*seeds.shape) < 0.3] = np.nan
    start = rng.randint(0, 20, size=(B, 3)).astype(np.int32)
    blocked = (rng.rand(2, *SHAPE) < 0.2).astype(np.uint8) * 3
    sv = rng.randint(0, 2, size=B).astype(np.int32)
    t = to_torch(dict(seeds=seeds, start=start, blocked=blocked, sv=sv), card)
    kw = dict(segment_threshold=float(np.float32(0.4)),
              move_threshold=MOVE_T)
    got = lane_ops.lane_verdicts(t["seeds"], t["sv"], t["start"],
                                 t["blocked"], **kw)
    want = lane_ops.lane_verdicts_plain(t["seeds"], t["sv"], t["start"],
                                        t["blocked"], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    for lane, box, size, origin in ((0, (0, 0, 0), SHAPE, (3, 4, 5)),
                                    (69, (3, 5, 7), (9, 17, 4), (19, 21, 23))):
        kw = dict(threshold=0.4, move_threshold=MOVE_T)
        got = lane_ops.lane_mask(t["seeds"], lane, box, size, origin, **kw)
        want = lane_ops.lane_mask_plain(t["seeds"], lane, box, size, origin,
                                        **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_hop_plain_runs_on_crafted_lanes():
    # The CPU side of the kernel tests: the crafted state drives every skip
    # kind, a stall, a cap, a weak origin and pushes through the plain path.
    from ffn_tpu_torch.ops import hop as hop_ops
    rng = np.random.RandomState(9)
    deltas = (2, 2, 2)
    lanes = crafted_lanes(rng, 37, SHAPE, 64, 9, deltas, 5)
    lanes["image"] = rng.randn(1, *SHAPE).astype(np.float32)
    s = to_torch(lanes, "cpu")
    tail0 = s["tail"].clone()
    out = hop_step(hop_ops, s, torch.from_numpy(tied_logits(rng, 37, 9)),
                   fov=9, pred=9, deltas=deltas, max_iters=5, disco=0.0)
    status = s["status"].numpy()
    for code in (hop_ops.STALLED_FULL, hop_ops.DONE_CAP, hop_ops.DONE_WEAK,
                 hop_ops.RUNNING):
        assert (status == code).any(), code
    for name in ("skip_threshold", "skip_invalid", "skip_restricted"):
        assert (s[name].numpy() >= 20).any(), name
    assert int(out[3][0]) == int(out[1].sum()) == int(out[3][1])
    assert (s["tail"] > tail0).any()


# -- K8 finalize_pass, K4 with the device segmentation, K7's batched masks ----

SEG_T = float(np.float32(np.log(0.6 / 0.4)))
INIT_T = float(np.float32(np.log(0.95 / 0.05)))


def crafted_finalize(rng, B, K, shape, Q, S, fov, deltas, max_iters,
                     min_size):
    """A LaneState, FinalizeState and blocked stack (numpy) that drive every
    branch of K8's pass: two same-pass finishers whose masks overlap, FIFO
    entries claimed before the pass (two in one slot, skipped by one pop)
    and during it, a FIFO that runs dry mid-pass, an object wider than the
    small blank block, a blank corner below 0 (it wraps, then clamps),
    `hold` on a DONE_EMPTY lane, a NaN origin, a capped lane, a too-small
    object, a seed on a BLOCKED_CLAIMED voxel, a zero-iteration lane, and
    idle, finalized, stalled and running lanes. Objects grow with the
    scale: boxes are fractions of `shape`."""
    margin = fov // 2
    shape = np.array(shape)
    dims = tuple(int(v) for v in shape)
    grid, _ = grid_geometry(dims, deltas)
    hi = shape - margin
    seeds = np.full((B,) + dims, np.nan, np.float32)
    start = rng.randint(margin, hi, size=(B, 3)).astype(np.int32)
    for b, s in enumerate(start):   # a small noisy blob around each origin
        box = tuple(slice(max(v - 2, 0), v + 3) for v in s)
        seeds[(b,) + box] = rng.uniform(-1.0, 4.0, seeds[(b,) + box].shape)
        seeds[(b,) + tuple(s)] = 3.0
    minp, maxp = start - 2, start + 2
    status = np.full(B, 1, np.int32)
    iters = rng.randint(1, max_iters, size=B).astype(np.int32)
    fresh = np.zeros(B, bool)
    sv = rng.randint(0, K, size=B).astype(np.int32)
    hold = np.zeros(B, bool)
    blocked = np.zeros((K,) + dims, np.uint8)
    blocked[rng.rand(K, *dims) < 0.03] = 2
    seg = np.zeros((K,) + dims, np.int32)
    q = shape // 4

    def obj(b, lo, hi_, k, origin, value=2.0):
        """Lane b holds the object [lo, hi_) of slot k, origin inside."""
        seeds[b] = np.nan
        box = tuple(slice(int(a), int(c)) for a, c in zip(lo, hi_))
        seeds[(b,) + box] = value
        start[b] = origin
        seeds[(b,) + tuple(origin)] = 3.0
        minp[b] = np.maximum(np.array(origin) - 2, lo)
        maxp[b] = np.minimum(np.array(origin) + 2, np.array(hi_) - 1)
        sv[b] = k

    lane = iter(range(B))
    b = next(lane)   # 0: finishes first, claims A
    obj(b, q, 3 * q, 0, 2 * q - 1)
    status[b] = 2
    b = next(lane)   # 1: overlaps A; segments what A left
    obj(b, 2 * q - 2, 3 * q + 2, 0, 3 * q)
    status[b] = 2
    b = next(lane)   # 2: capped, its seed inside A: claimed at finalize
    obj(b, q, 2 * q, 0, q + 1)
    status[b] = 4
    b = next(lane)   # 3: RUNNING at the cap: the dud kill caps it
    status[b], iters[b] = 1, max_iters
    b = next(lane)   # 4: RUNNING with a NaN origin: killed weak
    seeds[(b,) + tuple(start[b])] = np.nan
    b = next(lane)   # 5: DONE_EMPTY under hold: not finalized
    status[b], hold[b] = 2, True
    b = next(lane)   # 6: too small, in a corner no object reaches
    corner = np.ones(3, np.int64)
    obj(b, corner, corner + 1, 0, corner)
    status[b] = 2
    b = next(lane)   # 7: its seed on a BLOCKED_CLAIMED voxel
    blocked[(sv[b],) + tuple(start[b])] |= 1
    status[b] = 2
    b = next(lane)   # 8: zero executed moves
    status[b], iters[b] = 2, 0
    b = next(lane)   # 9: DONE_WEAK
    status[b] = 3
    b = next(lane)   # 10: wider than the small blank: the whole buffer
    obj(b, shape // 8, shape - shape // 8, 1, shape // 2)
    minp[b], maxp[b] = shape // 8, shape - shape // 8 - 1
    status[b] = 2
    b = next(lane)   # 11: blank corner below 0: wraps, then clamps
    seeds[b] = 0.0   # below the segment threshold: visible to the blank
    seeds[(b,) + tuple(start[b])] = 3.0
    minp[b] = (0, 2, 1)
    maxp[b] = minp[b] + 2
    status[b] = 2
    idle = [next(lane), next(lane)]          # 12, 13: IDLE
    status[idle] = 0
    status[next(lane)] = 6                   # 14: DONE_FINALIZED
    status[next(lane)] = 5                   # 15: STALLED_FULL
    for b in lane:                           # the rest keep running
        fresh[b] = rng.rand() < 0.3

    # Prior claims in slot 1; the FIFO: claimed entries first (two in slot
    # 1, skipped by one pop), one that lane 0's claim takes mid-pass, then
    # free seeds for all but the last idle lane, which pops claimed ones.
    seg[1, :q[0], :q[1], :] = 1
    next_sid = np.array([1, 2] + [1] * (K - 2), np.int32)
    free = []
    while len(free) < 12:
        p = rng.randint(margin, hi).astype(np.int32)
        p[2] = rng.randint(3 * q[2] + 2, shape[2])
        if tuple(p) not in {tuple(f) for f in free}:
            free.append(p)
    claimed_pos = np.array([q[0] // 2, q[1] // 2, 5], np.int32)
    blk_pos = rng.randint(margin, hi).astype(np.int32)
    blocked[(1,) + tuple(blk_pos)] |= 1
    fifo = ([(0, 2 * q - 1 - 1), (1, claimed_pos), (1, blk_pos)]
            + [(int(rng.randint(K)), f) for f in free]
            + [(1, claimed_pos), (1, blk_pos)])
    fifo_pos = np.zeros((S, 3), np.int32)
    fifo_sv = np.zeros(S, np.int32)
    for i, (k, p) in enumerate(fifo):
        fifo_sv[i], fifo_pos[i] = k, p
    L = S + B + 4
    z = np.zeros(B, np.int32)
    qpos = rng.randint(margin, hi, size=(B, Q, 3)).astype(np.int32)
    head = rng.randint(0, Q, size=B).astype(np.int32)
    lanes = dict(
        seeds=seeds, sv=sv, qpos=qpos,
        qscore=rng.rand(B, Q).astype(np.float32), head=head,
        tail=head + rng.randint(0, 8, size=B).astype(np.int32),
        done=(rng.rand(B, *grid) < 0.1).astype(np.uint8), start=start,
        minp=minp.astype(np.int32), maxp=maxp.astype(np.int32), iters=iters,
        status=status, fresh=fresh, overflow=z.copy(),
        skip_threshold=z.copy(), skip_invalid=z.copy(),
        skip_restricted=z.copy())
    fin = dict(seg=seg, next_sid=next_sid, fifo_pos=fifo_pos,
               fifo_sv=fifo_sv, fifo_n=np.array(len(fifo), np.int32),
               fifo_head=np.array(0, np.int32),
               log=np.zeros((L, 10), np.int32), log_n=np.array(0, np.int32),
               hold=hold, claimed=np.zeros(K, np.int32))
    opts = np.array([SEG_T, min_size, INIT_T], np.float32)
    return lanes, fin, blocked, opts


class _Fields:
    """Attribute access to a dict of tensors (LaneState / FinalizeState
    duck type for the K8 wrapper)."""

    def __init__(self, tensors):
        self.__dict__.update(tensors)


def finalize_step(fn, lanes, fin, blocked, opts, *, fov, deltas,
                  max_iters, move_threshold=MOVE_T):
    return fn(_Fields(lanes), _Fields(fin), blocked, fin_opts=opts,
              move_threshold=move_threshold, max_iters=max_iters,
              pred_size=(fov,) * 3, seed_size=(fov,) * 3, deltas=deltas)


def nan_equal(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b,
                                                                        nan=7.0))


@pytest.mark.cuda
def test_finalize_pass_matches_plain(card):
    from ffn_tpu_torch.ops import finalize as fin_ops
    rng = np.random.RandomState(11)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    blk = torch.from_numpy(blocked).to(card)
    ks = (to_torch(lanes, card), to_torch(fin, card))
    ps = (to_torch(lanes, card), to_torch(fin, card))
    kw = dict(fov=FOV, deltas=(2, 2, 2), max_iters=5)
    for _ in range(2):   # the second pass finds the first one's results
        got = finalize_step(fin_ops.finalize_pass, *ks, blk, opts, **kw)
        want = finalize_step(fin_ops.finalize_pass_plain, *ps, blk, opts,
                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for k, p in zip(ks, ps):
            for name in p:
                assert nan_equal(k[name], p[name]), name
    assert int(ps[1]["log_n"]) >= 11 and int(ps[1]["claimed"].sum()) >= 3


@pytest.mark.cuda
def test_hop_pop_with_seg_matches_plain(card):
    from ffn_tpu_torch.ops import hop as hop_ops
    rng = np.random.RandomState(12)
    lanes = crafted_lanes(rng, 37, SHAPE, 64, 9, (2, 2, 2), 5)
    lanes["image"] = rng.randn(1, *SHAPE).astype(np.float32)
    seg = np.where(rng.rand(1, *SHAPE) < 0.2, 3, 0).astype(np.int32)
    ks, ps = to_torch(lanes, card), to_torch(lanes, card)
    seg = torch.from_numpy(seg).to(card)
    grid_off = grid_geometry(SHAPE, (2, 2, 2))[1]
    outs = []
    for ops, s in ((hop_ops.hop_pop, ks), (hop_ops.hop_pop_plain, ps)):
        outs.append(ops(
            s["blocked"], s["shapes"], s["seeds"], s["sv"], s["qpos"],
            s["head"], s["tail"], s["done"], s["start"], s["iters"],
            s["status"], s["fresh"], s["skip_threshold"], s["skip_invalid"],
            s["skip_restricted"], s["executed"], s["pops"],
            move_threshold=MOVE_T, margin=(4,) * 3, deltas=(2, 2, 2),
            grid_offset=grid_off, max_iters=5, seg=seg))
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    assert_same(ks, ps)


@pytest.mark.cuda
def test_lane_masks_match_plain(card):
    from ffn_tpu_torch.ops import lane as lane_ops
    rng = np.random.RandomState(13)
    seeds = (rng.randn(9, *SHAPE) * 3).astype(np.float32)
    seeds[rng.rand(*seeds.shape) < 0.3] = np.nan
    t = torch.from_numpy(seeds).to(card)
    lanes = [0, 8, 3, 3]
    starts = [(0, 0, 0), (3, 5, 7), (10, 1, 2), (0, 0, 0)]
    sizes = [SHAPE, (9, 17, 4), (10, 21, 22), (1, 1, 1)]
    origins = [(3, 4, 5), (19, 21, 23), (10, 1, 2), (0, 0, 0)]
    kw = dict(threshold=0.4, move_threshold=MOVE_T)
    got = lane_ops.lane_masks(t, lanes, starts, sizes, origins, **kw)
    want = lane_ops.lane_masks_plain(t, lanes, starts, sizes, origins, **kw)
    assert torch.equal(got, want)


# -- K4-K7 on bfloat16 seeds (FFN_TPU_SEED_DTYPE=bf16) ------------------------

# logit(0.8) rounds down to bfloat16: a seed of bf16(MOVE_T_LO) is weak to K4
# and strong to K7.
MOVE_T_LO = float(np.float32(np.log(0.8 / 0.2)))


def bf16_seed_edges(rng, seeds, move_t):
    """Puts seeds on the move and segment thresholds' bfloat16 rounding
    edges (and 0.4, the segment threshold of these tests), sparing the
    crafted state's strong seeds (4.0: origins and queued entries)."""
    from ffn_tpu_torch.ops.hop import bf16_round
    edges = np.float32([bf16_round(move_t), move_t, bf16_round(0.4), 0.4,
                        np.nextafter(np.float32(bf16_round(move_t)), 10)])
    pick = (rng.rand(*seeds.shape) < 0.2) & (seeds != 4.0)
    seeds[pick] = rng.choice(edges, size=int(pick.sum()))


def assert_same_bf16(got, want):
    """assert_same with the bfloat16 seeds compared as float32 values."""
    assert got["seeds"].dtype == want["seeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["seeds"].float().cpu().numpy(),
                                  want["seeds"].float().cpu().numpy())
    assert_same({k: v for k, v in got.items() if k != "seeds"},
                {k: v for k, v in want.items() if k != "seeds"})


@pytest.mark.cuda
@pytest.mark.parametrize("deltas,pred,disco", [
    ((2, 2, 2), 9, 0.0), ((3, 0, 2), 7, -1.0), ((2, 3, 1), 9, 0.99)])
def test_hop_kernels_match_plain_bf16_seeds(card, deltas, pred, disco):
    # K4-K6's bfloat16 instantiations bit for bit against the plain
    # versions: a stored seed against the float32 move threshold (K4), the
    # pad rounded to bf16 (K5), the rounded write-back and the face maxima
    # of the rounded patch (K6). The launches count under *_bf16 only.
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import hop as hop_ops
    rng = np.random.RandomState(19)
    B, Q, fov, max_iters = 37, 64, 9, 5
    lanes = crafted_lanes(rng, B, SHAPE, Q, fov, deltas, max_iters)
    bf16_seed_edges(rng, lanes["seeds"], MOVE_T)
    lanes["image"] = rng.randn(1, *SHAPE).astype(np.float32)
    logits = tied_logits(rng, B, fov) + rng.randn(B, fov, fov, fov).astype(
        np.float32) * 1e-3
    ks, ps = to_torch(lanes, card), to_torch(lanes, card)
    ks["seeds"] = ks["seeds"].to(torch.bfloat16)
    ps["seeds"] = ps["seeds"].to(torch.bfloat16)
    lg = torch.from_numpy(logits).to(card)
    before = dict(_build.launches)
    for hop in range(3):
        got = hop_step(hop_ops, ks, lg, fov=fov, pred=pred, deltas=deltas,
                       max_iters=max_iters, disco=disco)
        want = hop_step(_PlainHop, ps, lg, fov=fov, pred=pred, deltas=deltas,
                        max_iters=max_iters, disco=disco)
        torch.cuda.synchronize()
        n_exec = int(want[3][0])
        assert n_exec > 0
        for g, w in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        np.testing.assert_array_equal(got[6][:n_exec].cpu().numpy(),
                                      want[6][:n_exec].cpu().numpy())
        assert_same_bf16(ks, ps)
    for name in (hop_ops.POP, hop_ops.GATHER, hop_ops.UPDATE):
        assert _build.launches[name + "_bf16"] == before.get(
            name + "_bf16", 0) + 3
        assert _build.launches[name] == before.get(name, 0)


@pytest.mark.cuda
def test_lane_threshold_matches_plain_bf16_seeds(card):
    # K7's bfloat16 instantiations: counts, masks and verdicts against the
    # thresholds rounded to bf16, at the rounding edges.
    from ffn_tpu_torch.ops import lane as lane_ops
    rng = np.random.RandomState(15)
    B = 70
    seeds = (rng.randn(B, *SHAPE) * 3).astype(np.float32)
    seeds[rng.rand(*seeds.shape) < 0.3] = np.nan
    bf16_seed_edges(rng, seeds, MOVE_T_LO)
    start = rng.randint(0, 20, size=(B, 3)).astype(np.int32)
    blocked = (rng.rand(2, *SHAPE) < 0.2).astype(np.uint8) * 3
    sv = rng.randint(0, 2, size=B).astype(np.int32)
    t = to_torch(dict(seeds=seeds, start=start, blocked=blocked, sv=sv), card)
    t["seeds"] = t["seeds"].to(torch.bfloat16)
    kw = dict(segment_threshold=0.4, move_threshold=MOVE_T_LO)
    got = lane_ops.lane_verdicts(t["seeds"], t["sv"], t["start"],
                                 t["blocked"], **kw)
    want = lane_ops.lane_verdicts_plain(t["seeds"], t["sv"], t["start"],
                                        t["blocked"], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    kw = dict(threshold=0.4, move_threshold=MOVE_T_LO)
    for lane, box, size, origin in ((0, (0, 0, 0), SHAPE, (3, 4, 5)),
                                    (69, (3, 5, 7), (9, 17, 4), (19, 21, 23))):
        got = lane_ops.lane_mask(t["seeds"], lane, box, size, origin, **kw)
        want = lane_ops.lane_mask_plain(t["seeds"], lane, box, size, origin,
                                        **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    lanes = [0, 8, 3, 69]
    starts = [(0, 0, 0), (3, 5, 7), (10, 1, 2), (0, 0, 0)]
    sizes = [SHAPE, (9, 17, 4), (10, 21, 22), (1, 1, 1)]
    origins = [(3, 4, 5), (19, 21, 23), (10, 1, 2), (0, 0, 0)]
    assert torch.equal(
        lane_ops.lane_masks(t["seeds"], lanes, starts, sizes, origins, **kw),
        lane_ops.lane_masks_plain(t["seeds"], lanes, starts, sizes, origins,
                                  **kw))


def test_finalize_plain_drives_every_branch():
    # The CPU side of the K8 card test: one plain pass over the crafted
    # state reaches every outcome, the overlap arbitration, the claimed
    # skips, the dry FIFO and both blanks.
    from ffn_tpu_torch.ops import finalize as fin_ops
    rng = np.random.RandomState(11)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    seeds0 = lanes["seeds"].copy()
    ls, fs = to_torch(lanes, "cpu"), to_torch(fin, "cpu")
    alive = finalize_step(fin_ops.finalize_pass, ls, fs,
                          torch.from_numpy(blocked), opts, fov=FOV,
                          deltas=(2, 2, 2), max_iters=5)
    assert int(alive[0]) == 1
    log = fs["log"][:int(fs["log_n"])].numpy()
    outcomes = dict(zip(log[:, 9].tolist(), log[:, 8].tolist()))
    assert outcomes[0] == outcomes[1] == fin_ops.FIN_SEGMENTED
    assert log[0, 1] == 1 and log[1, 1] == 2 and log[1, 6] < log[0, 6]
    assert outcomes[2] == fin_ops.FIN_CLAIMED
    assert outcomes[3] != fin_ops.FIN_INVALID and log[3, 7] == 4  # capped
    assert outcomes[4] == fin_ops.FIN_WEAK and 5 not in outcomes
    assert outcomes[6] == fin_ops.FIN_TOO_SMALL
    assert outcomes[7] == fin_ops.FIN_CLAIMED
    assert outcomes[8] == fin_ops.FIN_INVALID
    assert outcomes[9] == fin_ops.FIN_WEAK
    assert outcomes[10] == fin_ops.FIN_SEGMENTED
    status = ls["status"].numpy()
    assert status[5] == 2 and status[15] == 5
    refilled = status[[12, 13, 14]]   # the FIFO ran dry among them
    assert (refilled == 1).any() and (refilled == 6).any()
    assert int(fs["fifo_head"]) == int(fs["fifo_n"])
    assert fs["claimed"].tolist()[1] >= 4 and fs["claimed"].tolist()[0] >= 1
    # Lane 10 was blanked whole, lane 11 in the wrapped-then-clamped block.
    assert np.isnan(ls["seeds"][10].numpy()).sum() == np.prod(SHAPE) - 1
    blank = np.isnan(ls["seeds"][11].numpy()) & ~np.isnan(seeds0[11])
    idx = np.argwhere(blank)
    assert len(idx) and (idx.min(0) >= np.array(SHAPE) - 13).all()


def random_finalize(rng, B, K, shape, S, *, max_iters=5, min_size=1,
                    claimed_run=0, in_turn=0, fov=FOV, deltas=(2, 2, 2),
                    Q=8):
    """A random LaneState, FinalizeState and blocked stack (numpy) for K8:
    lanes of every status, each a noisy box of seeds around its origin (NaN,
    weak and strong origins) in a random slot, prior claims in seg and in
    blocked. Lane 0 finishes as a candidate and lane 1 (B > 1) finishes
    with its origin inside lane 0's mask in the same slot, claimed by lane
    0's turn if that turn writes. The FIFO opens with `claimed_run` entries
    on claimed voxels of slots 0 and 1 (alternating), then `in_turn` on
    lane 0's mask, where the first turn writes ids if its count reaches
    `min_size`, then free and claimed entries mixed."""
    dims = tuple(int(v) for v in shape)
    ext = np.array(dims)
    grid, _ = grid_geometry(dims, deltas)
    seeds = np.full((B,) + dims, np.nan, np.float32)
    start = np.stack([rng.randint(0, d, size=B) for d in dims],
                     1).astype(np.int32)
    minp, maxp = start.copy(), start.copy()
    sv = rng.randint(0, K, size=B).astype(np.int32)
    for b in range(B):
        r = rng.randint(1, 4, size=3)
        lo = np.maximum(start[b] - r, 0)
        hi = np.minimum(start[b] + r + 1, ext)
        box = (b,) + tuple(slice(int(a), int(c)) for a, c in zip(lo, hi))
        seeds[box] = rng.uniform(-1.0, 4.0, seeds[box].shape)
        seeds[(b,) + tuple(start[b])] = rng.choice([3.0, 3.0, 0.5, np.nan])
        minp[b], maxp[b] = lo, hi - 1
    status = rng.choice([0, 1, 2, 2, 2, 3, 4, 5, 6], size=B).astype(np.int32)
    iters = rng.randint(0, max_iters + 1, size=B).astype(np.int32)
    fresh = rng.rand(B) < 0.2
    hold = rng.rand(B) < 0.1
    seg = np.where(rng.rand(K, *dims) < 0.05,
                   rng.randint(1, 50, size=(K,) + dims), 0).astype(np.int32)
    blocked = ((rng.rand(K, *dims) < 0.05) * 2
               | (rng.rand(K, *dims) < 0.03)).astype(np.uint8)

    # Lane 0: a finisher that counts; lane 1: its origin in lane 0's mask.
    status[0], iters[0], hold[0] = 2, max(1, int(iters[0])), False
    s0 = (int(sv[0]),) + tuple(int(v) for v in start[0])
    seeds[(0,) + s0[1:]] = 3.0
    seg[s0], blocked[s0] = 0, blocked[s0] & 2
    mask0 = ((seeds[0] >= SEG_T) & (seg[sv[0]] == 0)
             & ((blocked[sv[0]] & 1) == 0))
    inside = np.argwhere(mask0)
    if B > 1:
        p1 = inside[rng.randint(len(inside))]
        status[1], iters[1], hold[1], sv[1] = 2, max(1, int(iters[1])), \
            False, sv[0]
        start[1] = p1
        minp[1], maxp[1] = np.minimum(minp[1], p1), np.maximum(maxp[1], p1)
        seeds[(1,) + tuple(p1)] = 3.0

    entries = []
    for i in range(claimed_run):
        k = i % min(K, 2)
        taken = np.argwhere((seg[k] > 0) | ((blocked[k] & 1) == 1))
        entries.append((k, taken[rng.randint(len(taken))]))
    for _ in range(in_turn):
        entries.append((int(sv[0]), inside[rng.randint(len(inside))]))
    while len(entries) < S:
        k = int(rng.randint(K))
        taken = np.argwhere((seg[k] > 0) | ((blocked[k] & 1) == 1))
        p = taken[rng.randint(len(taken))] if rng.rand() < 0.5 else \
            np.array([rng.randint(d) for d in dims])
        entries.append((k, p))
    fifo_pos = np.zeros((S, 3), np.int32)
    fifo_sv = np.zeros(S, np.int32)
    for i, (k, p) in enumerate(entries[:S]):
        fifo_sv[i], fifo_pos[i] = k, p
    n = int(rng.randint(max(1, S - 8), S + 1)) if S > claimed_run + \
        in_turn else S
    head = rng.randint(0, Q, size=B).astype(np.int32)
    z = np.zeros(B, np.int32)
    lanes = dict(
        seeds=seeds, sv=sv,
        qpos=rng.randint(0, min(dims), size=(B, Q, 3)).astype(np.int32),
        qscore=rng.rand(B, Q).astype(np.float32), head=head,
        tail=head + rng.randint(0, 4, size=B).astype(np.int32),
        done=(rng.rand(B, *grid) < 0.1).astype(np.uint8), start=start,
        minp=minp.astype(np.int32), maxp=maxp.astype(np.int32), iters=iters,
        status=status, fresh=fresh, overflow=z.copy(),
        skip_threshold=z.copy(), skip_invalid=z.copy(),
        skip_restricted=z.copy())
    fin = dict(seg=seg, next_sid=rng.randint(50, 60, size=K).astype(np.int32),
               fifo_pos=fifo_pos, fifo_sv=fifo_sv,
               fifo_n=np.array(n, np.int32), fifo_head=np.array(0, np.int32),
               log=np.zeros((S + B + 4, 10), np.int32),
               log_n=np.array(0, np.int32), hold=hold,
               claimed=np.zeros(K, np.int32))
    opts = np.array([SEG_T, min_size, INIT_T], np.float32)
    return lanes, fin, blocked, opts


def _k8_against_plain(card, lanes, fin, blocked, opts, passes=2,
                      seed_dtype=torch.float32, move_threshold=MOVE_T,
                      max_iters=5, fov=FOV):
    """K8 and finalize_pass_plain from the same state, `passes` passes:
    equal bit for bit (NaN-equal seeds) after each; each K8 call one launch
    and one device kernel. Returns the plain state."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import finalize as fin_ops
    name = "finalize_pass_bf16" if seed_dtype == torch.bfloat16 else \
        "finalize_pass"
    blk = torch.from_numpy(blocked).to(card)
    ks = (to_torch(lanes, card), to_torch(fin, card))
    ps = (to_torch(lanes, card), to_torch(fin, card))
    for st in (ks, ps):
        st[0]["seeds"] = st[0]["seeds"].to(seed_dtype)
    kw = dict(fov=fov, deltas=(2, 2, 2), max_iters=max_iters,
              move_threshold=move_threshold)
    # The wrapper's scratch, made (zeroed) on a stream's first call.
    dev = ks[0]["seeds"].device
    fin_ops._scratch(dev, torch.cuda.current_stream(dev).cuda_stream)
    for _ in range(passes):
        before = _build.launches[name]
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            got = finalize_step(fin_ops.finalize_pass, *ks, blk, opts, **kw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert _build.launches[name] == before + 1
        assert len(kernels) == 1 and "finalize_pass" in kernels[0].name, \
            [e.name for e in kernels]
        want = finalize_step(fin_ops.finalize_pass_plain, *ps, blk, opts,
                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for k, p in zip(ks, ps):
            for key in p:
                assert nan_equal(k[key], p[key]), key
    return ps


@pytest.mark.cuda
@pytest.mark.parametrize("alive", [0, 1])
@pytest.mark.parametrize("seed_dtype", [torch.float32, torch.bfloat16])
def test_finalize_pass_empty(card, alive, seed_dtype):
    # A pass that finalizes nothing: no finisher and no idle lane with the
    # FIFO dry (alive 0), or lanes still running (alive 1).
    rng = np.random.RandomState(40 + alive)
    lanes, fin, blocked, opts = random_finalize(rng, 64, 2, SHAPE, 16)
    lanes["status"][:] = 5   # STALLED_FULL
    if alive:
        lanes["status"][::3] = 1   # running, fresh: not killed
        lanes["fresh"][:] = True
        lanes["iters"][:] = 1
    ps = _k8_against_plain(card, lanes, fin, blocked, opts,
                           seed_dtype=seed_dtype)
    assert int(ps[1]["log_n"]) == 0 and int(ps[1]["fifo_head"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 33, 64, 1024])
def test_finalize_pass_lane_counts(card, B):
    rng = np.random.RandomState(100 + B)
    shape = (12, 13, 14) if B == 1024 else SHAPE
    lanes, fin, blocked, opts = random_finalize(
        rng, B, 3, shape, max(8, B // 2), claimed_run=3, in_turn=2)
    ps = _k8_against_plain(card, lanes, fin, blocked, opts)
    assert int(ps[1]["log_n"]) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed_dtype", [torch.float32, torch.bfloat16])
def test_finalize_pass_long_claimed_run(card, seed_dtype):
    # More than 64 claimed FIFO entries in slots 0 and 1 before a free
    # one: the pop skips them 32 a step and counts each slot's.
    rng = np.random.RandomState(51)
    lanes, fin, blocked, opts = random_finalize(
        rng, 24, 3, SHAPE, 120, claimed_run=70)
    ps = _k8_against_plain(card, lanes, fin, blocked, opts,
                           seed_dtype=seed_dtype)
    claimed = ps[1]["claimed"].cpu().numpy()
    assert claimed[0] >= 35 and claimed[1] >= 35


@pytest.mark.cuda
@pytest.mark.parametrize("min_size", [1, 10 ** 6])
def test_finalize_pass_in_turn_candidate(card, min_size):
    # The FIFO's head inside the mask that lane 0's turn writes: claimed by
    # the write when the count reaches min_size, free when too small.
    rng = np.random.RandomState(52)
    lanes, fin, blocked, opts = random_finalize(
        rng, 16, 2, SHAPE, 24, min_size=min_size, in_turn=3)
    ps = _k8_against_plain(card, lanes, fin, blocked, opts)
    log = ps[1]["log"][:int(ps[1]["log_n"])].cpu().numpy()
    assert log[0, 9] == 0
    assert log[0, 8] == (1 if min_size == 1 else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 33, 33), (41, 48, 57),
                                   (132, 132, 132)])
@pytest.mark.parametrize("seed_dtype", [torch.float32, torch.bfloat16])
def test_finalize_pass_volumes(card, shape, seed_dtype):
    # Odd volumes put every lane and slot offset off the 16-byte grid
    # (scalar scans); 132^3, the devfin slice's, aligns them.
    rng = np.random.RandomState(sum(shape))
    lanes, fin, blocked, opts = random_finalize(
        rng, 6, 3, shape, 12, claimed_run=2, in_turn=2, fov=33)
    _k8_against_plain(card, lanes, fin, blocked, opts,
                      seed_dtype=seed_dtype, fov=33)


@pytest.mark.cuda
def test_finalize_pass_repeats(card):
    # The same state through K8 three times: identical results (the
    # scratch is left ready, nothing depends on the blocks' order).
    from ffn_tpu_torch.ops import finalize as fin_ops
    rng = np.random.RandomState(53)
    lanes, fin, blocked, opts = random_finalize(
        rng, 64, 4, (40, 41, 42), 64, claimed_run=5, in_turn=3)
    blk = torch.from_numpy(blocked).to(card)
    outs = []
    for _ in range(3):
        ls, fs = to_torch(lanes, card), to_torch(fin, card)
        alive = finalize_step(fin_ops.finalize_pass, ls, fs, blk, opts,
                              fov=FOV, deltas=(2, 2, 2), max_iters=5)
        torch.cuda.synchronize()
        outs.append((alive, {**ls, **fs}))
    for alive, st in outs[1:]:
        assert torch.equal(alive, outs[0][0])
        for key, t in st.items():
            assert nan_equal(t, outs[0][1][key]), key


# -- K9-K12: the training path's kernels ---------------------------------------

from ffn_tpu_torch.ops import optim as optim_ops  # noqa: E402
from ffn_tpu_torch.ops import train as train_ops  # noqa: E402


def test_training_kernels_reject_bad_inputs():
    dy = torch.zeros(1, 4, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3d.conv3d_dgrad_f32(dy, torch.zeros(3, 3, 3, 2, 4))
    with pytest.raises(ValueError):
        conv3d.conv3d_wgrad_f32(torch.zeros(1, 4, 4, 5, 2), dy, 3)
    with pytest.raises(ValueError):
        conv3d.Conv3dFunction.apply(torch.zeros(1, 4, 4, 4, 8),
                                    torch.zeros(3, 3, 3, 8, 8),
                                    torch.zeros(8), dy, False, True)
    with pytest.raises(ValueError):
        train_ops.train_gather(torch.zeros(2, 5, 5), torch.zeros(2, 5, 5, 5),
                               torch.zeros(2, 5, 5, 5), (0, 0, 0), (3,) * 3,
                               0.0, 0.5)
    p = [torch.zeros(3)]
    with pytest.raises(ValueError):
        optim_ops.optim_update(p, [torch.zeros(4)], [None], [None], None,
                               optim_ops.Hyper("sgd", 0.1), None, None,
                               torch.tensor(1.0), torch.tensor(True))
    with pytest.raises(ValueError):
        optim_ops.optim_update(p, [torch.zeros(3)], [None], [None], None,
                               optim_ops.Hyper("lion", 0.1), None, None,
                               torch.tensor(1.0), torch.tensor(True))
    with pytest.raises(ValueError):
        train_ops.fov_loss(torch.zeros(1, 3, 3, 3, 1), torch.zeros(1, 3, 3, 3),
                           torch.zeros(1, 3, 3, 3, 1), torch.zeros(1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k9_k10_match_plain(card, case):
    # Within 1e-4 of max|plain|: float32 sums in another order than
    # cuDNN's, TF32 off.
    k, cin, cout, pre, post, res = K1_CASES[case]
    gen = torch.Generator(device=card).manual_seed(9)
    shape = (2, 9, 10, 11)
    x = torch.randn(*shape, cin, generator=gen, device=card)
    w = torch.randn(k, k, k, cin, cout, generator=gen, device=card) * 0.2
    dy = torch.randn(*shape, cout, generator=gen, device=card)
    y = torch.randn(*shape, cout, generator=gen, device=card) \
        if post else None
    xm = x if pre else None
    acc = torch.randn(*shape, cin, generator=gen, device=card) \
        if pre and post else None
    got = conv3d.conv3d_dgrad_f32(dy, w, x=xm, y=y, accum=acc)
    want = conv3d.conv3d_dgrad_plain(dy, w, x=xm, y=y, accum=acc)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), ("K9", case, err)
    gw, gb = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
    ww, wb = conv3d.conv3d_wgrad_plain(x, dy, k, pre_relu=pre, y=y)
    for g, want in ((gw, ww), (gb, wb)):
        err = float((g - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), ("K10", case, err)
    again = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
    assert torch.equal(again[0], gw) and torch.equal(again[1], gb)


# K9's 3^3 kernel beyond the stack's FOV: one voxel, H = 1, W = 1, rows
# across tiles, the card tests' (2, 9, 10, 11), N = 20 at 9^3 (several tiles
# a persistent CTA), rows wider than a tile (three row bands a plane, g in
# the smallest chunks).
K9_SHAPES = [(1, 1, 1, 1), (2, 3, 1, 5), (1, 4, 5, 1), (1, 3, 4, 200),
             (2, 9, 10, 11), (20, 9, 9, 9), (1, 2, 3, 700)]
K9_CASES = dict(K1_CASES, **{"16->16": (3, 16, 16, True, True, False)})


def _same_alone_and_again(fn, dy, w, kw):
    """fn's result on the batch; a repeat bit for bit, the middle sample
    alone bit for bit as in the batch."""
    got = fn(dy, w, **kw)
    assert torch.equal(got, fn(dy, w, **kw))
    i = dy.shape[0] // 2
    one = fn(dy[i:i + 1].clone(), w, **{k: None if v is None else
                                        v[i:i + 1].clone()
                                        for k, v in kw.items()})
    assert torch.equal(one[0], got[i])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K9_CASES))
@pytest.mark.parametrize("shape", K9_SHAPES)
def test_k9_matches_plain_on_odd_shapes(card, case, shape):
    # Within 1e-4 of max|plain| (test_k9_k10_match_plain's bound), every
    # layer kind, deterministic and N-independent.
    k, cin, cout, pre, post, _ = K9_CASES[case]
    gen = torch.Generator(device=card).manual_seed(sum(shape) + cin)
    x = torch.randn(*shape, cin, generator=gen, device=card)
    w = torch.randn(k, k, k, cin, cout, generator=gen, device=card) * 0.2
    dy = torch.randn(*shape, cout, generator=gen, device=card)
    y = torch.randn(*shape, cout, generator=gen, device=card) \
        if post else None
    acc = torch.randn(*shape, cin, generator=gen, device=card) \
        if pre and post else None
    kw = dict(x=x if pre else None, y=y, accum=acc)
    if shape == (1, 2, 3, 700) and k == 3:
        geo = conv3d.k9_geometry(*shape, cin, cout, post)
        assert geo.band_stride < geo.pitch and geo.chunk <= 8
    got = _same_alone_and_again(conv3d.conv3d_dgrad_f32, dy, w, kw)
    want = conv3d.conv3d_dgrad_plain(dy, w, **kw)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), (case, shape, err)


# K10's chunk tiles across their plan (conv3d.k10_geometry): B = 1 and 4
# on the FOV, odd volumes, rows split into columns (W = 700); every 3^3
# layer kind of the stack and the CI checkpoint's 16->16. Within 1e-4 of
# max|plain| (test_k9_k10_match_plain's bound), two runs bit for bit.
K10_SHAPES = [(1, 33, 33, 33), (4, 33, 33, 33), (1, 1, 1, 1), (2, 3, 1, 5),
              (1, 3, 4, 200), (1, 2, 3, 700), (3, 9, 10, 11)]
K10_CASES = {name: K9_CASES[name] for name in
             ("conv0_a", "conv0_b", "block_a", "block_b", "16->16")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K10_CASES))
@pytest.mark.parametrize("shape", K10_SHAPES)
def test_k10_matches_plain_across_its_plan(card, case, shape):
    k, cin, cout, pre, post, _ = K10_CASES[case]
    gen = torch.Generator(device=card).manual_seed(sum(shape) + cin + cout)
    x = torch.randn(*shape, cin, generator=gen, device=card)
    dy = torch.randn(*shape, cout, generator=gen, device=card)
    y = torch.randn(*shape, cout, generator=gen, device=card) \
        if post else None
    assert conv3d.k10_geometry(*shape, cin, cout, post) is not None
    gw, gb = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
    ww, wb = conv3d.conv3d_wgrad_plain(x, dy, k, pre_relu=pre, y=y)
    for g, want in ((gw, ww), (gb, wb)):
        err = float((g - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (case, shape, err)
    again = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
    assert torch.equal(again[0], gw) and torch.equal(again[1], gb)


@pytest.mark.cuda
def test_conv3d_function_backward_matches_autograd_of_plain(card):
    from ffn_tpu_torch.models import convstack_3d
    torch.manual_seed(0)
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=3, features=8)
    model.module.to(card)
    gen = torch.Generator(device=card).manual_seed(1)
    net = torch.randn(2, 9, 9, 9, 2, generator=gen, device=card)
    seed = net[..., 1:].contiguous()
    dl = torch.randn(2, 9, 9, 9, 1, generator=gen, device=card)
    params = list(model.module.parameters())
    got = torch.autograd.grad(model.train_apply(net, seed), params, dl)
    from unittest import mock
    with mock.patch.object(convstack_3d, "conv3d_train",
                           conv3d.conv3d_ndhwc_plain), \
            mock.patch.object(convstack_3d, "residual_block_train",
                              conv3d.residual_block_plain):
        want = torch.autograd.grad(model.train_apply(net, seed), params, dl)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _k11_canvases(card, b=3, c=17, seed=11):
    rng = np.random.RandomState(seed)
    image_u8 = torch.from_numpy(
        rng.randint(0, 256, (b, c, c, c, 1)).astype(np.uint8)).to(card)
    lom_u8 = torch.from_numpy(
        (rng.rand(b, c, c, c, 1) > 0.5).astype(np.uint8)).to(card)
    return image_u8, lom_u8, rng


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, (3, (4, 4, 4))])
def test_k11_matches_plain(card, window):
    image_u8, lom_u8, rng = _k11_canvases(card)
    args = ((17, 17, 17), 128.0, 33.0, 0.05, float(np.log(0.05 / 0.95)),
            float(np.log(0.95 / 0.05)))
    got = train_ops.train_prep(image_u8, lom_u8, *args)
    want = train_ops.train_prep_plain(image_u8[..., 0], lom_u8[..., 0],
                                      *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    images, labels, seeds = want
    # Seeds and labels on both sides of the gates.
    seeds = torch.from_numpy((rng.randn(3, 17, 17, 17) * 3).astype(
        np.float32)).to(card)
    labels = torch.from_numpy(rng.choice([0.05, 0.95], (3, 17, 17, 17))
                              .astype(np.float32)).to(card)
    weights = torch.from_numpy(rng.rand(3, 17, 17, 17).astype(
        np.float32)).to(card)
    ticket = train_ops.new_ticket(card)
    fov = (9, 9, 9)
    for off in [(0, 0, 0), (4, -4, 0), (-4, 4, 4), (0, 0, -4)]:
        kg = train_ops.train_gather(seeds, images, labels, off, fov,
                                    MOVE_T, 0.9, window)
        pg = train_ops.train_gather_plain(seeds, images, labels, off, fov,
                                          MOVE_T, 0.9, window)
        for g, w in zip(kg, pg):
            assert torch.equal(g, w), off
        logits = torch.from_numpy((rng.randn(3, 9, 9, 9, 1) * 4).astype(
            np.float32)).to(card)
        for wts in (None, weights):
            ks, ps = seeds.clone(), seeds.clone()
            km = torch.zeros(5, device=card)
            pm = torch.zeros(5, device=card)
            kd = train_ops.train_loss(logits, ks, labels, wts, kg[2], kg[3],
                                      off, km, ticket)
            pd = train_ops.train_loss_plain(logits, ps, labels, wts, kg[2],
                                            kg[3], off, pm)
            assert torch.equal(ks, ps)
            assert torch.equal(km[1:], pm[1:])
            torch.testing.assert_close(km[0], pm[0], rtol=1e-5, atol=0)
            torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-9)
    kl, kc = train_ops.train_eval(seeds, labels, (13, 13, 13), ticket)
    pl, pc = train_ops.train_eval_plain(seeds, labels, (13, 13, 13))
    assert torch.equal(kc, pc)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_k11_gradient_at_zero_matches_plain(card):
    # At a logit of exactly 0 both give jax.grad's -w z coef; +-30 and a
    # NaN beside it.
    rng = np.random.RandomState(111)
    labels = torch.from_numpy(rng.choice([0.05, 0.95], (2, 13, 13, 13))
                              .astype(np.float32)).to(card)
    weights = torch.from_numpy(rng.rand(2, 13, 13, 13).astype(
        np.float32)).to(card)
    x = (rng.randn(2, 9, 9, 9, 1) * 3).astype(np.float32)
    x.reshape(-1)[:8] = [0.0, -0.0, 30.0, -30.0, 0.0, np.nan, 0.0, 0.0]
    logits = torch.from_numpy(x).to(card)
    valid = torch.tensor([True, True], device=card)
    seeds = torch.zeros((2, 13, 13, 13), device=card)
    km, pm = torch.zeros(5, device=card), torch.zeros(5, device=card)
    kd = train_ops.train_loss(logits, seeds.clone(), labels, weights, valid,
                              valid, (0, 0, 0), km,
                              train_ops.new_ticket(card))
    pd = train_ops.train_loss_plain(logits, seeds.clone(), labels, weights,
                                    valid, valid, (0, 0, 0), pm)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-9, equal_nan=True)
    at0 = logits == 0
    want = -(weights * labels)[:, 2:11, 2:11, 2:11, None] / (729 * 2.0)
    torch.testing.assert_close(kd[at0], want[at0], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", optim_ops.OPTIMIZERS)
@pytest.mark.parametrize("schedule", [False, True])
def test_k12_matches_plain(card, opt, schedule):
    rng = np.random.RandomState(12)
    shapes = [(3, 3, 3, 4, 8), (8,), (1, 1, 1, 8, 1), (1,)]
    h = optim_ops.Hyper(opt, 0.05, decay_steps=2 if schedule else None,
                        decay_rate=0.5 if schedule else None,
                        ema_decay=0.9)
    slots = {"sgd": 0, "momentum": 1, "adagrad": 1}.get(opt, 2)

    def state():
        p = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
             for s in shapes]
        s1 = [torch.full_like(t, 0.1) for t in p] if slots >= 1 else \
            [None] * len(p)
        s2 = [torch.zeros_like(t) for t in p] if slots == 2 else \
            [None] * len(p)
        return p, s1, s2, [t.clone() for t in p]

    kp, ks1, ks2, ke = state()
    pp, ps1, ps2, pe = (
        [t.clone() if t is not None else None for t in ts]
        for ts in (kp, ks1, ks2, ke))
    counts = [torch.zeros((), dtype=torch.int32, device=card)
              for _ in range(4)]
    ctrl = optim_ops.ctrl_buffer(card)
    for step in range(6):
        grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
                 for s in shapes]
        if step == 3:
            grads[1][2] = float("nan")
        active = torch.tensor(0.0 if step == 4 else 2.0, device=card)
        kf = torch.zeros((), dtype=torch.bool, device=card)
        pf = torch.zeros((), dtype=torch.bool, device=card)
        optim_ops.optim_update(kp, grads, ks1, ks2, ke, h, counts[0],
                               counts[1] if schedule else None, active, kf,
                               ctrl)
        optim_ops.optim_update_plain(pp, grads, ps1, ps2, pe, h, counts[2],
                                     counts[3] if schedule else None, active,
                                     pf)
        assert bool(kf) == bool(pf) == (step != 3)
        assert torch.equal(counts[0], counts[2])
        for a, b in zip(kp + ke + [t for t in ks1 + ks2 if t is not None],
                        pp + pe + [t for t in ps1 + ps2 if t is not None]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_k12_ungated_matches_plain(card):
    # The host-loop trainer's legacy step: no gate, so a NaN gradient
    # reaches the parameters and the counts advance, in both versions.
    rng = np.random.RandomState(13)
    shapes = [(3, 3, 3, 4, 8), (8,)]
    h = optim_ops.Hyper("adam", 0.05)
    kp = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
          for s in shapes]
    ks1, ks2 = ([torch.zeros_like(t) for t in kp] for _ in range(2))
    pp, ps1, ps2 = ([t.clone() for t in ts] for ts in (kp, ks1, ks2))
    counts = [torch.zeros((), dtype=torch.int32, device=card)
              for _ in range(2)]
    ctrl = optim_ops.ctrl_buffer(card)
    active = torch.tensor(0.0, device=card)
    for step in range(3):
        grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
                 for s in shapes]
        if step == 2:
            grads[1][2] = float("nan")
        kf = torch.zeros((), dtype=torch.bool, device=card)
        pf = torch.zeros((), dtype=torch.bool, device=card)
        optim_ops.optim_update(kp, grads, ks1, ks2, None, h, counts[0], None,
                               active, kf, ctrl, gated=False)
        optim_ops.optim_update_plain(pp, grads, ps1, ps2, None, h, counts[1],
                                     None, active, pf, gated=False)
        assert bool(kf) == bool(pf) == (step != 2)
        assert int(counts[0]) == int(counts[1]) == step + 1
        for a, b in zip(kp + ks1 + ks2, pp + ps1 + ps2):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       equal_nan=True)
    assert bool(torch.isnan(kp[1][2])) and not bool(torch.isnan(kp[1][3]))


@pytest.mark.cuda
def test_k16_kernel_matches_plain(card):
    # The loss within 1e-5 relative (float32 sums of 19,652 terms in
    # another order), the gradient within 1e-6 of max|plain| (expf and the
    # division against torch.sigmoid's roundings); NaN where the plain
    # version has NaN; twice bit for bit.
    rng = np.random.RandomState(16)
    shape = (4, 17, 17, 17, 1)
    x = (rng.randn(*shape) * 4).astype(np.float32)
    x.reshape(-1)[:6] = [0.0, 30.0, -30.0, -0.0, 88.0, -88.0]
    y = rng.choice([0.05, 0.95], shape).astype(np.float32)
    w = (rng.rand(*shape) > 0.3).astype(np.float32) * rng.rand(*shape)
    w = w.astype(np.float32)
    ticket = train_ops.new_ticket(card)
    args = [torch.from_numpy(a).to(card) for a in (x, y, w)]
    for nan in (False, True):
        if nan:
            args[0][1, 3, 4, 5, 0] = float("nan")
        kd, kl = train_ops.fov_loss(*args, ticket)
        pd, pl = train_ops.fov_loss_plain(*args)
        again = train_ops.fov_loss(*args, ticket)
        for a, b in zip(again, (kd, kl)):   # deterministic: bit for bit
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0,
                                   equal_nan=True)
        atol = 1e-6 * float(pd.nan_to_num().abs().max())
        torch.testing.assert_close(kd, pd, rtol=0, atol=atol, equal_nan=True)
        assert int(ticket) == 0


# -- K13-K14: the round-based batched step ------------------------------------

from ffn_tpu_torch.ops import select as select_ops  # noqa: E402


def crafted_select(rng, B, K, shape, fixed=False):
    """Seeds (B, *shape) and the (B, 3K+5) int32 upload of one round that
    drives every branch of K13 and K14: NaN seeds, candidates on NaN and
    below the move threshold ahead of a valid one, a lane with none valid,
    ignore, weak and NaN starts, inactive lanes, candidates on every face
    and out of the volume. fixed: step_batch's round (K = 1, the start at
    the candidate, ignore everywhere)."""
    dims = np.array(shape)
    seeds = (rng.randn(B, *shape) * 3).astype(np.float32)
    seeds[rng.rand(B, *shape) < 0.3] = np.nan
    cands = rng.randint(0, dims, size=(B, K, 3)).astype(np.int32)
    start = rng.randint(0, dims, size=(B, 3)).astype(np.int32)
    strong, weak = np.float32(MOVE_T + 1), np.float32(MOVE_T - 1)
    for b in range(B):
        seeds[(b,) + tuple(start[b])] = strong
        seeds[(b,) + tuple(cands[b, -1])] = strong
    seeds[(1,) + tuple(start[1])] = weak
    seeds[(2,) + tuple(start[2])] = np.nan
    seeds[(3,) + tuple(cands[3, 0])] = np.nan
    if K > 1:
        seeds[(3,) + tuple(cands[3, 1])] = weak
    for k in range(K):
        seeds[(4,) + tuple(cands[4, k])] = np.nan if k % 2 else weak
    faces = [(0, 0, 0), dims - 1, (1, dims[1] - 2, 3),
             (-2, dims[1] + 3, dims[2] - 1), (dims[0] - 1, 2, 0)]
    for b, p in zip(range(5, 10), faces):
        cands[b, 0] = p
        idx = np.clip(np.where(cands[b, 0] < 0, cands[b, 0] + dims,
                               cands[b, 0]), 0, dims - 1)
        seeds[(b,) + tuple(idx)] = strong
    active = rng.rand(B) < 0.9
    active[[0, 3, 4, 5, 7, 8, 9]] = True
    active[6] = False
    ignore = rng.rand(B) < 0.2
    ignore[[1, 2, 3]] = False
    ignore[[0, 4]] = True
    if fixed:
        cands = cands[:, :1]
        start = cands[:, 0]
        ignore[:] = True
    packed = np.concatenate([cands.reshape(B, -1), start,
                             active[:, None], ignore[:, None]],
                            axis=1).astype(np.int32)
    return seeds, packed


def select_round(ops, image, seeds, packed, logits, *, fov, pred, deltas,
                 disco, move_threshold=MOVE_T):
    """K13 -> (fixed logits) -> K14 through `ops`; returns (img, seed_in,
    rec, packed row, masked)."""
    img, seed_in, rec = ops.select_gather(
        image, seeds, packed, image_size=(fov,) * 3, seed_size=(fov,) * 3,
        move_threshold=move_threshold, pad=PAD)
    row, masked = ops.select_update(
        logits, seeds, rec, pred_size=(pred,) * 3, deltas=deltas,
        move_threshold=move_threshold, disco_threshold=disco)
    return img, seed_in, rec, row, masked


class _PlainSelect:
    from ffn_tpu_torch.ops.select import (
        select_gather_plain as select_gather,
        select_update_plain as select_update)


@pytest.mark.cuda
@pytest.mark.parametrize("K,fixed,pred,deltas,disco", [
    (4, False, FOV, (2, 2, 2), 0.0), (1, True, FOV, (2, 2, 2), 0.5),
    (3, False, 7, (3, 0, 2), -1.0)])
def test_select_kernels_match_plain(card, K, fixed, pred, deltas, disco):
    rng = np.random.RandomState(13)
    B = 37
    seeds, packed = crafted_select(rng, B, K, SHAPE, fixed)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(card)
    logits = tied_logits(rng, B, FOV)
    logits[3, 4, 4, 1] = np.nan
    lg = torch.from_numpy(logits).to(card)
    pk = torch.from_numpy(packed).to(card)
    ks = torch.from_numpy(seeds).to(card)
    ps = ks.clone()
    kw = dict(fov=FOV, pred=pred, deltas=deltas, disco=disco)
    got = select_round(select_ops, image, ks, pk, lg, **kw)
    want = select_round(_PlainSelect, image, ps, pk, lg, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("img", "seed_in", "rec", "row", "masked"), got,
                          want):
        assert g.shape == w.shape and nan_equal(g, w), name
    assert nan_equal(ks, ps)
    rec = want[2].cpu().numpy()
    assert rec[:, 0].any() and not rec[:, 0].all()
    assert not rec[[1, 2, 6], 0].any() or fixed


def test_select_plain_runs_on_crafted_rounds():
    """The crafted round's branches, on the CPU: executed, chosen and
    start_ok as the JAX program computes them (tests/test_torch_select.py
    holds them to it)."""
    rng = np.random.RandomState(13)
    seeds, packed = crafted_select(rng, 12, 3, SHAPE)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
    lg = torch.from_numpy(tied_logits(rng, 12, FOV))
    _, _, rec, row, _ = select_round(
        _PlainSelect, image, torch.from_numpy(seeds),
        torch.from_numpy(packed), lg, fov=FOV, pred=FOV, deltas=(2, 2, 2),
        disco=0.0)
    rec = rec.numpy()
    assert rec[[1, 2, 6], 0].tolist() == [0, 0, 0]   # weak, NaN, inactive
    assert rec[3, 1] == 2 and rec[4, 1] == 0 and rec[0, 1] == 0
    assert rec[[5, 7, 8, 9], 0].all()
    assert np.isinf(row.numpy()[rec[:, 0] == 0, 3:9]).all()


# -- K2, K3, K8, K13, K14 on bfloat16 seeds -----------------------------------

# A segment threshold that rounds down to bfloat16 too.
SEG_T_LO = float(np.float32(0.299))


def bf16_edges(move_t, seg_t=SEG_T_LO):
    """bfloat16 seed values on the thresholds' rounding edges: bf16(move_t)
    (below a move_t that rounds down) and the next bfloat16 above it,
    bf16(seg_t) and the next one below it."""
    from ffn_tpu_torch.ops.hop import bf16_round
    move_bf, seg_bf = bf16_round(move_t), bf16_round(seg_t)
    return np.float32([move_bf, bf16_round(move_bf * (1 + 2 ** -8)), seg_bf,
                       bf16_round(seg_bf * (1 - 2 ** -8))])


def bf16_round_array(values):
    """float32 numpy values rounded to bfloat16, back in float32."""
    return torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(
        torch.bfloat16).float().numpy()


def bf16_finalize_edges(rng, lanes, fin, opts, move_t):
    """crafted_finalize's state for bfloat16 seeds, in place: SEG_T_LO,
    objects on bf16_edges, lanes 16 (RUNNING) and 17 (DONE_EMPTY) on the
    origin bf16(move_t) < move_t (weak to the dud kill, strong to the
    verdict); the seeds rounded to bfloat16 (as float32)."""
    opts[0] = SEG_T_LO
    seeds = lanes["seeds"]
    edges = bf16_edges(move_t)
    for b in (0, 1, 10):
        box = np.nonzero(seeds[b] == 2.0)
        pick = rng.rand(len(box[0])) < 0.4
        seeds[(b,) + tuple(a[pick] for a in box)] = rng.choice(
            edges, size=int(pick.sum()))
    for b in (16, 17):
        seeds[(b,) + tuple(lanes["start"][b])] = edges[0]
    lanes["status"][16], lanes["fresh"][16], lanes["iters"][16] = 1, False, 2
    lanes["status"][17], fin["hold"][17], lanes["iters"][17] = 2, False, 3
    lanes["seeds"] = bf16_round_array(seeds)


def bf16_select_edges(rng, seeds, packed, move_t):
    """crafted_select's round for bfloat16 seeds, in place: seeds on
    bf16_edges, starts and candidates at bf16(move_t) < move_t on some
    lanes; the seeds rounded to bfloat16 (as float32)."""
    B = seeds.shape[0]
    K = (packed.shape[1] - 5) // 3
    edges = bf16_edges(move_t)
    pick = rng.rand(*seeds.shape) < 0.15
    seeds[pick] = rng.choice(edges, size=int(pick.sum()))
    dims = np.array(seeds.shape[1:])
    for b in rng.choice(B, size=B // 3, replace=False):
        k = rng.randint(K + 1)   # K: the start
        p = packed[b, 3 * k:3 * k + 3]
        idx = np.clip(np.where(p < 0, p + dims, p), 0, dims - 1)
        seeds[(b,) + tuple(idx)] = edges[rng.randint(2)]
    seeds[...] = bf16_round_array(seeds)


def _bf16_launches(names):
    from ffn_tpu_torch import _build
    return {n: _build.launches[n] for n in names}


@pytest.mark.cuda
@pytest.mark.parametrize("disco", [-1.0, 0.0, 0.5])
def test_step_kernels_match_plain_bf16_seeds(card, disco):
    # K2/K3's bfloat16 instantiations bit for bit against the plain
    # versions: the pad rounded to bf16, the disco mask on the stored old
    # seed, the rounded write-back and the unrounded returned patch.
    rng = np.random.RandomState(16)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(card)
    seed_np = (rng.randn(*SHAPE) * 3).astype(np.float32)
    seed_np[rng.rand(*SHAPE) < 0.3] = np.nan
    pick = rng.rand(*SHAPE) < 0.2
    seed_np[pick] = rng.choice(bf16_edges(MOVE_T_LO), size=int(pick.sum()))
    names = ("step_gather", "step_update", "step_gather_bf16",
             "step_update_bf16")
    before = _bf16_launches(names)
    for pos in POSITIONS:
        seed = torch.from_numpy(seed_np).to(card).to(torch.bfloat16)
        got = step_ops.step_gather(image, seed, pos, (FOV,) * 3, (7, 7, 7),
                                   PAD)
        want = step_ops.step_gather_plain(image, seed, pos, (FOV,) * 3,
                                          (7, 7, 7), PAD)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        logits = torch.from_numpy((rng.randn(FOV, FOV, FOV) * 3).astype(
            np.float32)).to(card)
        pseed = seed.clone()
        kpatch = step_ops.step_update(logits, seed, pos, (7, 7, 7),
                                      MOVE_T_LO, disco)
        ppatch = step_ops.step_update_plain(logits, pseed, pos, (7, 7, 7),
                                            MOVE_T_LO, disco)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(kpatch.cpu().numpy(),
                                      ppatch.cpu().numpy())
        np.testing.assert_array_equal(seed.float().cpu().numpy(),
                                      pseed.float().cpu().numpy())
        assert kpatch.dtype == torch.float32 and seed.dtype == torch.bfloat16
    after = _bf16_launches(names)
    n = len(POSITIONS)
    assert [after[k] - before[k] for k in names] == [0, 0, n, n]


@pytest.mark.cuda
@pytest.mark.parametrize("K,fixed,pred,deltas,disco", [
    (4, False, FOV, (2, 2, 2), 0.0), (1, True, FOV, (2, 2, 2), 0.5),
    (3, False, 7, (3, 0, 2), -1.0)])
def test_select_kernels_match_plain_bf16_seeds(card, K, fixed, pred, deltas,
                                               disco):
    # K13/K14's bfloat16 instantiations: starts and candidates against the
    # unrounded move threshold, the pad rounded, the rounded write-back
    # with its face maxima, the unrounded masked crops.
    rng = np.random.RandomState(17)
    B = 37
    seeds, packed = crafted_select(rng, B, K, SHAPE, fixed)
    bf16_select_edges(rng, seeds, packed, MOVE_T_LO)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(card)
    logits = tied_logits(rng, B, FOV) + rng.randn(B, FOV, FOV, FOV).astype(
        np.float32) * 1e-3
    lg = torch.from_numpy(logits).to(card)
    pk = torch.from_numpy(packed).to(card)
    ks = torch.from_numpy(seeds).to(card).to(torch.bfloat16)
    ps = ks.clone()
    kw = dict(fov=FOV, pred=pred, deltas=deltas, disco=disco,
              move_threshold=MOVE_T_LO)
    names = ("select_gather", "select_update", "select_gather_bf16",
             "select_update_bf16")
    before = _bf16_launches(names)
    got = select_round(select_ops, image, ks, pk, lg, **kw)
    want = select_round(_PlainSelect, image, ps, pk, lg, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("img", "seed_in", "rec", "row", "masked"), got,
                          want):
        assert g.shape == w.shape and nan_equal(g, w), name
    assert ks.dtype == torch.bfloat16 and nan_equal(ks, ps)
    after = _bf16_launches(names)
    assert [after[k] - before[k] for k in names] == [0, 0, 1, 1]


@pytest.mark.cuda
def test_finalize_pass_matches_plain_bf16_seeds(card):
    # K8's bfloat16 instantiation: the dud kill against the float32 move
    # threshold, the verdict and the claim mask against thresholds rounded
    # to bf16, bf16 blanks and the rounded init activation.
    from ffn_tpu_torch.ops import finalize as fin_ops
    rng = np.random.RandomState(18)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    bf16_finalize_edges(rng, lanes, fin, opts, MOVE_T_LO)
    blk = torch.from_numpy(blocked).to(card)
    ks = (to_torch(lanes, card), to_torch(fin, card))
    ps = (to_torch(lanes, card), to_torch(fin, card))
    for s in (ks, ps):
        s[0]["seeds"] = s[0]["seeds"].to(torch.bfloat16)
    kw = dict(fov=FOV, deltas=(2, 2, 2), max_iters=5,
              move_threshold=MOVE_T_LO)
    before = _bf16_launches(("finalize_pass", "finalize_pass_bf16"))
    for _ in range(2):   # the second pass finds the first one's results
        got = finalize_step(fin_ops.finalize_pass, *ks, blk, opts, **kw)
        want = finalize_step(fin_ops.finalize_pass_plain, *ps, blk, opts,
                             **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for k, p in zip(ks, ps):
            for name in p:
                assert nan_equal(k[name], p[name]), name
    log = ps[1]["log"][:int(ps[1]["log_n"])].cpu().numpy()
    first = {}
    for row in log:
        first.setdefault(int(row[9]), int(row[8]))
    assert first[16] == fin_ops.FIN_WEAK and first[17] != fin_ops.FIN_WEAK
    after = _bf16_launches(("finalize_pass", "finalize_pass_bf16"))
    assert after["finalize_pass"] == before["finalize_pass"]
    assert after["finalize_pass_bf16"] == before["finalize_pass_bf16"] + 2


def test_bf16_crafted_states_hit_their_edges():
    """The bfloat16 crafted states reach their edges (on the CPU)."""
    from ffn_tpu_torch.ops import finalize as fin_ops
    rng = np.random.RandomState(18)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    bf16_finalize_edges(rng, lanes, fin, opts, MOVE_T_LO)
    st = (to_torch(lanes, "cpu"), to_torch(fin, "cpu"))
    st[0]["seeds"] = st[0]["seeds"].to(torch.bfloat16)
    finalize_step(fin_ops.finalize_pass_plain, *st, torch.from_numpy(blocked),
                  opts, fov=FOV, deltas=(2, 2, 2), max_iters=5,
                  move_threshold=MOVE_T_LO)
    rows = st[1]["log"][:int(st[1]["log_n"])].numpy()
    outcome = {int(r[9]): int(r[8]) for r in rows}
    assert outcome[16] == fin_ops.FIN_WEAK
    # Past the verdict's start test: claimed by an earlier finalization.
    assert outcome[17] == fin_ops.FIN_CLAIMED
    rng = np.random.RandomState(17)
    seeds, packed = crafted_select(rng, 37, 4, SHAPE)
    bf16_select_edges(rng, seeds, packed, MOVE_T_LO)
    assert (seeds == bf16_edges(MOVE_T_LO)[0]).any()
    np.testing.assert_array_equal(seeds[~np.isnan(seeds)],
                                  bf16_round_array(seeds[~np.isnan(seeds)]))


# -- reduced-precision training: K15 in float16, K17, K18, K12's scale ------

HALF = [torch.bfloat16, torch.float16]


def test_16bit_backward_rejects_bad_inputs():
    w = torch.zeros(3, 3, 3, 4, 4)
    with pytest.raises(TypeError):
        conv3d.conv3d_dgrad_16(torch.zeros(1, 5, 5, 5, 4), w)
    with pytest.raises(TypeError):
        conv3d.conv3d_wgrad_16(torch.zeros(1, 5, 5, 5, 4),
                               torch.zeros(1, 5, 5, 5, 4), 3)
    with pytest.raises(TypeError):
        conv3d.conv3d_wgrad_16(torch.zeros(1, 5, 5, 5, 4).bfloat16(),
                               torch.zeros(1, 5, 5, 5, 4).half(), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["conv0_a", "block_a", "block_b",
                                  "conv_lom"])
def test_k15_float16_matches_plain_and_exact(card, case):
    gen = torch.Generator(device=card).manual_seed(151)
    k, _, _, pre, post, _, _ = K15_CASES[case]
    x, w, b, r = k15_inputs(gen, 3, (33, 33, 33), case, torch.float16)
    kw = dict(pre_relu=pre, post_relu=post, residual=r)
    got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
    want = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
    err = (got.float() - want.float()).abs() / k15_tolerance(x, w, b, **kw)
    assert float(err.max()) <= 1.0 and differ_share(got, want) <= \
        DIFFER_SHARE
    assert torch.equal(got, conv3d_ndhwc_bf16_exact(x, w, b, **kw))


# K15's 3^3 geometry (conv3d.k15_geometry, mirrored from conv3d_bf16.cu's
# launch_tc): tiles of K15_TILE_ROWS positions q = y P + x of one z-plane,
# P = W + 1, each with a halo of three planes of R rows. The stack's FOV,
# odd shapes that end mid-tile and the hop path's 64 lanes.
K15_GEO_SHAPES = [(1, 33, 33, 33), (2, 5, 7, 9), (1, 1, 1, 1),
                  (1, 33, 17, 40), (3, 17, 33, 11), (64, 33, 33, 33)]


@pytest.mark.parametrize("shape", K15_GEO_SHAPES)
@pytest.mark.parametrize("widths", conv3d.BF16_SHAPES)
def test_k15_tiles_cover_every_voxel_once(shape, widths):
    n, d, h, w = shape
    geo = conv3d.k15_geometry(n, d, h, w, *widths)
    assert geo.tiles == n * d * geo.per_plane
    seen = np.zeros((n, d, h, w), np.int64)
    for t in range(geo.tiles):
        b, z, ys, xs = geo.voxels(t)
        np.add.at(seen, (b, z, ys.numpy(), xs.numpy()), 1)
    assert (seen == 1).all()
    assert geo.smem == conv3d.k15_smem(geo.halo_rows, *widths)
    assert geo.smem <= conv3d.K15_SMEM


def test_k15_tiles_waste_little_at_33_and_two_ctas_share_an_sm():
    # 33 * 34 - 1 positions in 9 tiles of 128: 5.8% padded slots (an 8x4x4
    # box wasted 44%).
    for widths in conv3d.BF16_SHAPES:
        geo = conv3d.k15_geometry(1, 33, 33, 33, *widths)
        assert geo.per_plane == 9
        assert geo.per_plane * conv3d.K15_TILE_ROWS / 33 ** 2 < 1.06
        assert geo.smem <= conv3d.K15_SMEM_TWO


def test_k15_geometry_refuses_rows_too_wide():
    geo = conv3d.k15_geometry(1, 4, 4, 200, 32, 32)
    assert conv3d.K15_SMEM_TWO < geo.smem <= conv3d.K15_SMEM
    with pytest.raises(ValueError):
        conv3d.k15_geometry(1, 4, 4, 300, 32, 32)


@pytest.mark.parametrize("shape", [(1, 5, 7, 9), (2, 3, 4, 33),
                                   (1, 1, 1, 1), (1, 2, 40, 3)])
def test_k15_halo_rows_and_tap_offsets_give_the_convolution(shape):
    # The kernel's index arithmetic in numpy: each tile's halo (plane dz
    # row h the voxel at q0 - P - 1 + h, zero outside the volume and in the
    # zero column), each tap one row offset dz R + dy P + dx, the rows past
    # the plane or in the zero column dropped; against F.conv3d.
    n, d, h, w = shape
    rng = np.random.default_rng(sum(shape))
    cin, cout = 3, 2
    x = rng.standard_normal((n, d, h, w, cin))
    wt = rng.standard_normal((3, 3, 3, cin, cout))
    geo = conv3d.k15_geometry(n, d, h, w, 2, 16)
    p, r, rows = geo.pitch, geo.halo_rows, conv3d.K15_TILE_ROWS
    y = np.full((n, d, h, w, cout), np.nan)
    for t in range(geo.tiles):
        b, z = t // (d * geo.per_plane), t // geo.per_plane % d
        q0 = t % geo.per_plane * rows
        stage = np.zeros((3, r, cin))
        q = q0 - p - 1 + np.arange(r)
        ok = (q >= 0) & (q < h * p) & (q % p < w)
        for dz in range(3):
            if 0 <= z + dz - 1 < d:
                stage[dz, ok] = x[b, z + dz - 1, q[ok] // p, q[ok] % p]
        acc = sum(stage[dz, np.arange(rows) + dy * p + dx] @ wt[dz, dy, dx]
                  for dz in range(3) for dy in range(3) for dx in range(3))
        _, _, ys, xs = geo.voxels(t)
        keep = (ys * p + xs - q0).numpy()
        y[b, z, ys.numpy(), xs.numpy()] = acc[keep]
    want = torch.nn.functional.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3),
        torch.from_numpy(wt).permute(4, 3, 0, 1, 2),
        padding=1).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)


# K9's 3^3 geometry (conv3d.k9_geometry, mirrored from conv3d_bwd.cu's
# K9Plan): tiles of K9_TILE_POS plane positions and a block of dx channels;
# W' and g's halo chunks in shared memory. Widths of the stack, the CI
# checkpoint, the card tests' odd ones and dx channels beyond a block.
K9_GEO_WIDTHS = [(32, 32), (16, 16), (13, 40), (2, 32), (40, 13)]
K9_GEO_SHAPES = [(1, 33, 33, 33), (2, 5, 7, 9), (1, 1, 1, 1), (2, 3, 1, 5),
                 (1, 2, 3, 200), (1, 2, 3, 700)]


@pytest.mark.parametrize("shape", K9_GEO_SHAPES)
@pytest.mark.parametrize("widths", K9_GEO_WIDTHS)
def test_k9_tiles_cover_every_voxel_and_channel_once(shape, widths):
    n, d, h, w = shape
    cin, cout = widths
    geo = conv3d.k9_geometry(n, d, h, w, cin, cout, True)
    cip = 4 * geo.cig
    assert (geo.ci_blocks - 1) * cip < cin <= geo.ci_blocks * cip
    assert geo.tiles == geo.ci_blocks * n * d * geo.per_plane
    seen = np.zeros((geo.ci_blocks, n, d, h, w), np.int64)
    for t in range(geo.tiles):
        b, i, z, ys, xs = geo.voxels(t)
        np.add.at(seen, (b, i, z, ys.numpy(), xs.numpy()), 1)
    assert (seen == 1).all()
    assert geo.smem == 4 * (geo.g_block * geo.w_row + geo.stage)
    assert geo.smem <= conv3d.K15_SMEM and geo.threads == 96 * geo.cig


def test_k9_geometry_at_33_stages_the_weights_once():
    # 33 * 34 - 1 positions in 3 tiles of 384: 5.5% padded slots (the 3x8x4
    # box 24%); 396 tiles at B=4, three for each of 132 persistent CTAs;
    # W' for all 32 g channels (110.6 KB) beside one stage of 8 (masked: y
    # beside g) or 16 g channels.
    for masked, chunk in ((True, 8), (False, 16)):
        geo = conv3d.k9_geometry(4, 33, 33, 33, 32, 32, masked)
        assert geo.per_plane == 3 and geo.tiles == 3 * 132
        assert geo.per_plane * conv3d.K9_TILE_POS / 33 ** 2 < 1.06
        assert (geo.g_block, geo.chunk, geo.threads) == (32, chunk, 768)
        assert geo.halo_rows == 2 * 34 + conv3d.K9_TILE_POS + 2
        assert geo.smem <= conv3d.K15_SMEM
    # 16->16 (the CI checkpoint): 12 warps a CTA, two CTAs an SM.
    geo = conv3d.k9_geometry(4, 33, 33, 33, 16, 16, True)
    assert geo.threads == 384 and geo.smem <= conv3d.K15_SMEM_TWO


@pytest.mark.parametrize("masked", [False, True])
def test_k9_wide_rows_take_three_row_bands(masked):
    # Rows wider than a tile: each tile stages three bands of 386 rows a
    # plane, so the halo, and W' for 32 g channels, fit whatever W is; the
    # chunk of g channels shrinks as the rows grow, then stays.
    geos = [conv3d.k9_geometry(1, 2, 2, w, 32, 32, masked)
            for w in (33, 200, 384, 385, 600, 5000, 100000)]
    assert [g.band_stride for g in geos] == [34, 202, 386, 386, 386, 386, 386]
    assert all(g.halo_rows == 2 * g.band_stride + conv3d.K9_TILE_POS + 2
               for g in geos)
    assert all(g.g_block == 32 and g.smem <= conv3d.K15_SMEM for g in geos)
    chunks = [g.chunk for g in geos]
    assert chunks == sorted(chunks, reverse=True) and chunks[-1] == (
        4 if masked else 8) and chunks[-1] == chunks[-3]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("widths", [(1, 1), (3, 7), (16, 16), (32, 32),
                                    (64, 256), (300, 3)])
def test_k9_geometry_fits_every_shape(widths, masked):
    # The search ends at g_block = chunk = 1 at the latest, which fits the
    # CTA's budget however wide the rows and the layer are.
    cin, cout = widths
    for w in (1, 385, 10 ** 6):
        geo = conv3d.k9_geometry(1, 3, 2, w, cin, cout, masked)
        budget = conv3d.K15_SMEM_TWO if geo.cig < 8 else conv3d.K15_SMEM
        assert 1 <= geo.chunk <= geo.g_block <= min(cout, 32)
        assert geo.smem == 4 * (geo.g_block * geo.w_row + geo.stage)
        assert geo.smem <= budget
    last = conv3d.k9_geometry(1, 3, 2, 10 ** 6, 300, 300, True)
    assert 4 * (last.w_row + 3 * last.halo_rows * 2) <= 31.3e3


@pytest.mark.parametrize("shape,widths", [((1, 5, 7, 9), (13, 40)),
                                          ((2, 3, 4, 33), (32, 32)),
                                          ((1, 1, 1, 1), (4, 3)),
                                          ((1, 2, 40, 3), (16, 16)),
                                          ((1, 2, 2, 300), (40, 13)),
                                          ((1, 2, 2, 500), (8, 4))])
def test_k9_halo_rows_and_windows_give_the_input_gradient(shape, widths):
    # The kernel's index arithmetic in numpy: each tile's g (plane dz row h
    # the voxel at halo position h of plane z + dz - 1, zero outside the
    # volume and in the zero column), y's mask on the staged copies,
    # W'[c][tap'][ci] = W[26 - tap'][ci][c], output row r reading row
    # dy S + r + dx of plane dz, the dx channel block, the x mask and accum;
    # against conv3d_dgrad_plain.
    n, d, h, w = shape
    cin, cout = widths
    rng = np.random.default_rng(sum(shape) + cin)
    dy, y = (rng.standard_normal((n, d, h, w, cout)) for _ in "dy")
    x, acc = (rng.standard_normal((n, d, h, w, cin)) for _ in "xa")
    wt = rng.standard_normal((3, 3, 3, cin, cout))
    geo = conv3d.k9_geometry(n, d, h, w, cin, cout, True)
    p, band, cip = geo.pitch, geo.band_stride, 4 * geo.cig
    wf = wt.reshape(27, cin, cout)[::-1].transpose(2, 0, 1)
    rows = np.arange(conv3d.K9_TILE_POS)
    out = np.full((n, d, h, w, cin), np.nan)
    for t in range(geo.tiles):
        b, i, z, ys, xs = geo.voxels(t)
        q0 = t % geo.per_plane * conv3d.K9_TILE_POS
        q = geo.halo_positions(t).numpy()
        ok = (q >= 0) & (q < h * p) & (q % p < w)
        stage = np.zeros((cout, 3, geo.halo_rows))
        for dz in range(3):
            if 0 <= z + dz - 1 < d:
                at = (i, z + dz - 1, q[ok] // p, q[ok] % p)
                stage[:, dz, ok] = np.where(y[at] > 0, dy[at], 0.0).T
        ci = slice(b * cip, min(b * cip + cip, cin))
        tile = np.zeros((conv3d.K9_TILE_POS, ci.stop - ci.start))
        for c in range(cout):
            for tap in range(27):
                dz, dyy, dx = tap // 9, tap // 3 % 3, tap % 3
                tile += np.outer(stage[c, dz, rows + dyy * band + dx],
                                 wf[c, tap, ci])
        ys, xs = ys.numpy(), xs.numpy()
        at = (i, z, ys, xs, ci)
        out[at] = np.where(x[at] > 0, tile[ys * p + xs - q0], 0) + acc[at]
    want = conv3d.conv3d_dgrad_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (dy, wt)),
        x=torch.from_numpy(x), y=torch.from_numpy(y),
        accum=torch.from_numpy(acc)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-10, atol=1e-10)


# K1's 3^3 geometry (conv3d.k1_geometry, mirrored from conv3d.cu's
# k1_plan): K9's tiles with x staged and y written, the output channels
# split into blocks while the tiles are fewer than two an SM. K9's shapes
# and widths (Cin, Cout), the input layers at 2 channels, the train
# batch's 33^3 volume.
K1_GEO_WIDTHS = K9_GEO_WIDTHS + [(2, 16)]
K1_GEO_SHAPES = K9_GEO_SHAPES + [(4, 33, 33, 33)]


@pytest.mark.parametrize("shape", K1_GEO_SHAPES)
@pytest.mark.parametrize("widths", K1_GEO_WIDTHS)
def test_k1_tiles_cover_every_voxel_and_channel_once(shape, widths):
    n, d, h, w = shape
    cin, cout = widths
    geo = conv3d.k1_geometry(n, d, h, w, cin, cout)
    cip = 4 * geo.cig
    assert (geo.ci_blocks - 1) * cip < cout <= geo.ci_blocks * cip
    assert geo.tiles == geo.ci_blocks * n * d * geo.per_plane
    seen = np.zeros((n, d, h, w, cout), np.int64)
    for t in range(geo.tiles):
        b, i, z, ys, xs = geo.voxels(t)
        co = np.arange(b * cip, min(b * cip + cip, cout))
        np.add.at(seen, (i, z, ys.numpy()[:, None], xs.numpy()[:, None],
                         co[None, :]), 1)
    assert (seen == 1).all()
    # The stage holds real input channels only: 2 at the input layers.
    assert geo.chunk <= geo.g_block <= min(cin, conv3d.K9_GBLOCK)


def _k1_share(geo, sms=conv3d.H100_SMS):
    """The CTAs whose share of an SM a K1 CTA takes: as many as an SM has
    tiles, at most 8 / cig (24 warps)."""
    return max(1, min(8 // geo.cig, -(-geo.tiles // sms)))


def test_k1_splits_the_output_channels_to_fill_the_card():
    # A 33^3 sample has 99 tiles of 384 positions for 132 SMs. At N = 1,
    # 32->32 splits into four blocks of 8 channels (396 tiles, three an SM,
    # each CTA a third of its shared memory, so all run at once, in chunks
    # of 8 channels); at N = 2 into two; at N = 4 (the train batch) 396
    # tiles of 32 channels, W (110.6 KB) staged once a CTA beside 16
    # channels' stage. The CI checkpoint's 16->16 at N = 1: four blocks of
    # 4. Beside each stage, the halo table of its rows' voxels.
    for n, cig, blocks, share, chunk in ((1, 2, 4, 3, 8), (2, 4, 2, 2, 8),
                                         (4, 8, 1, 1, 16), (64, 8, 1, 1, 16)):
        geo = conv3d.k1_geometry(n, 33, 33, 33, 32, 32)
        assert (geo.cig, geo.ci_blocks, _k1_share(geo), geo.chunk) == (
            cig, blocks, share, chunk), n
        assert geo.tiles >= 2 * conv3d.H100_SMS
        assert share * (geo.smem + 1024) <= conv3d.SMEM_SM
        assert geo.g_block == 32 and geo.table == geo.halo_rows
    geo = conv3d.k1_geometry(4, 33, 33, 33, 32, 32)
    assert (geo.tiles, geo.w_row) == (396, 27 * 32 + 4)
    assert geo.per_plane * conv3d.K9_TILE_POS / 33 ** 2 < 1.06
    geo = conv3d.k1_geometry(1, 33, 33, 33, 16, 16)
    assert (geo.cig, geo.ci_blocks, geo.tiles) == (1, 4, 396)
    # The input layer stages its 2 channels, none padded.
    geo = conv3d.k1_geometry(64, 33, 33, 33, 2, 32)
    assert geo.g_block == geo.chunk == 2 and geo.cig == 8
    # A card with fewer SMs splits less.
    assert conv3d.k1_geometry(1, 33, 33, 33, 32, 32, sms=40).cig == 8


@pytest.mark.parametrize("n", [1, 4, 64])
@pytest.mark.parametrize("widths", [(1, 1), (2, 32), (3, 7), (16, 16),
                                    (32, 32), (64, 256), (300, 3)])
def test_k1_geometry_fits_every_shape(widths, n):
    # A CTA's weights, stage and halo table fit its share of the SM however
    # wide the rows and the layer are (one input channel at a time takes at
    # most 31.3 KB).
    cin, cout = widths
    for w in (1, 33, 385, 10 ** 6):
        geo = conv3d.k1_geometry(n, 3, 2, w, cin, cout)
        assert 1 <= geo.chunk <= geo.g_block <= min(cin, 32)
        assert geo.smem == 4 * (geo.g_block * geo.w_row + geo.stage
                                + geo.halo_rows)
        assert geo.smem <= conv3d.SMEM_SM // _k1_share(geo) - 1024
        assert geo.threads == conv3d.K9_RUNS * geo.cig


# K1's layer kinds at the full width: (k, Cin, Cout, pre_relu, post_relu,
# residual); shapes (N, D, H, W) ending mid-tile, rows wider than a tile
# (three row bands), one voxel.
K1_KINDS = {k: K1_CASES[k] for k in ("conv0_a", "block_a", "block_b",
                                     "conv_lom")}
K1_ODD_SHAPES = [(1, 1, 1, 1), (2, 5, 7, 9), (1, 2, 3, 200), (1, 2, 3, 700)]


def _k1_model(x, wt, b, r, pre, post):
    """K1's index arithmetic in numpy (float64 sums): 3^3 layers tile by
    tile on k1_geometry's plan (x's halo rows staged channel-major, pre_relu
    on the staged copies, output row m reading row dy S + m + dx of plane
    dz, weight rows [ci][tap][co] of the tile's output block; then + bias,
    post_relu, + residual); 1^3 layers a voxel's channels in order."""
    n, d, h, w, cin = x.shape
    k, cout = wt.shape[0], wt.shape[-1]
    if k == 1:
        xs = np.maximum(x, 0) if pre else x
        y = xs.reshape(-1, cin).astype(np.float64) @ wt.reshape(cin, cout)
        y = y.reshape(n, d, h, w, cout) + b
        y = np.maximum(y, 0) if post else y
        return y + r if r is not None else y
    geo = conv3d.k1_geometry(n, d, h, w, cin, cout)
    p, band, cip = geo.pitch, geo.band_stride, 4 * geo.cig
    wf = wt.reshape(27, cin, cout).astype(np.float64)
    rows = np.arange(conv3d.K9_TILE_POS)
    y = np.full((n, d, h, w, cout), np.nan)
    for t in range(geo.tiles):
        blk, i, z, ys, xs = geo.voxels(t)
        q0 = t % geo.per_plane * conv3d.K9_TILE_POS
        q = geo.halo_positions(t).numpy()
        ok = (q >= 0) & (q < h * p) & (q % p < w)
        stage = np.zeros((cin, 3, geo.halo_rows))
        for dz in range(3):
            if 0 <= z + dz - 1 < d:
                stage[:, dz, ok] = x[i, z + dz - 1, q[ok] // p, q[ok] % p].T
        if pre:
            stage = np.maximum(stage, 0)
        co = slice(blk * cip, min(blk * cip + cip, cout))
        tile = np.zeros((conv3d.K9_TILE_POS, co.stop - co.start))
        for tap in range(27):
            dz, dyy, dx = tap // 9, tap // 3 % 3, tap % 3
            tile += stage[:, dz, rows + dyy * band + dx].T @ wf[tap, :, co]
        ys, xs = ys.numpy(), xs.numpy()
        v = tile[ys * p + xs - q0] + b[co]
        v = np.maximum(v, 0) if post else v
        if r is not None:
            v = v + r[i, z, ys, xs, co]
        y[i, z, ys, xs, co] = v
    return y


@pytest.mark.parametrize("kind", list(K1_KINDS))
@pytest.mark.parametrize("shape", K1_ODD_SHAPES)
def test_k1_index_model_matches_lax_conv(kind, shape):
    # Within 1e-5 of max|ref| (float32 against float64 sums), as
    # test_torch_convstack.py's test_k1_plain_matches_lax_conv.
    jnp = pytest.importorskip("jax.numpy")
    from jax import lax
    k, cin, cout, pre, post, res = K1_KINDS[kind]
    rng = np.random.default_rng(sum(shape) + cin)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    wt = (rng.standard_normal((k, k, k, cin, cout))
          * (2.0 / (k ** 3 * cin)) ** 0.5).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    r = rng.standard_normal(shape + (cout,)).astype(np.float32) \
        if res else None
    got = _k1_model(x, wt, b, r, pre, post)
    xin = np.maximum(x, 0) if pre else x
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xin), jnp.asarray(wt), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST) + b)
    if post:
        want = np.maximum(want, 0)
    if res:
        want = want + r
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 8, 64, 256])
@pytest.mark.parametrize("spatial", [s[1:] for s in K1_ODD_SHAPES])
def test_k1_matches_plain_on_odd_shapes(card, n, spatial):
    # Every layer kind within 1e-4 of max|plain|, a repeat bit for bit, the
    # middle sample alone (N = 1, its own plan) bit for bit as in the batch.
    gen = torch.Generator(device=card).manual_seed(n + sum(spatial))
    for case, (k, cin, cout, pre, post, res) in K1_CASES.items():
        shape = (n,) + spatial
        x = torch.randn(*shape, cin, generator=gen, device=card)
        w = torch.randn(k, k, k, cin, cout, generator=gen, device=card) \
            * (2.0 / (k ** 3 * cin)) ** 0.5
        b = torch.randn(cout, generator=gen, device=card) * 0.1
        r = torch.randn(*shape, cout, generator=gen, device=card) \
            if res else None
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        got = conv3d.conv3d_ndhwc_f32(x, w, b, **kw)
        assert torch.equal(got, conv3d.conv3d_ndhwc_f32(x, w, b, **kw))
        want = conv3d.conv3d_ndhwc_plain(x, w, b, **kw)
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (case, shape, err)
        i = n // 2
        one = conv3d.conv3d_ndhwc_f32(
            x[i:i + 1].clone(), w, b, pre_relu=pre, post_relu=post,
            residual=None if r is None else r[i:i + 1].clone())
        assert torch.equal(one[0], got[i]), (case, shape)


@pytest.mark.cuda
def test_k1_sample_alone_equals_it_inside_a_batch_of_64(card):
    # The 33^3 FOV: N = 1 takes four channel blocks a tile, N = 64 one;
    # every output sums in the same order, so the two agree bit for bit.
    gen = torch.Generator(device=card).manual_seed(64)
    for case in ("conv0_a", "block_a", "block_b", "conv_lom"):
        k, cin, cout, pre, post, res = K1_CASES[case]
        x = torch.randn(64, 33, 33, 33, cin, generator=gen, device=card)
        w = torch.randn(k, k, k, cin, cout, generator=gen, device=card) * 0.1
        b = torch.randn(cout, generator=gen, device=card)
        r = torch.randn(64, 33, 33, 33, cout, generator=gen, device=card) \
            if res else None
        kw = dict(pre_relu=pre, post_relu=post)
        got = conv3d.conv3d_ndhwc_f32(x, w, b, residual=r, **kw)
        for i in (0, 37, 63):
            one = conv3d.conv3d_ndhwc_f32(
                x[i:i + 1].clone(), w, b,
                residual=None if r is None else r[i:i + 1].clone(), **kw)
            assert torch.equal(one[0], got[i]), (case, i)


# Layer kinds of K15_CASES that cover the four (Cin, Cout) pairs with every
# flag: float32 x, pre_relu and post_relu, a 16-bit residual.
K15_3X3_CASES = ["conv0_a", "block_a", "block_b", "ci_conv0_a", "ci_block_b"]
# Odd shapes ending mid-tile; N = 100 at 9^3 gives each persistent CTA
# several tiles (900 tiles).
K15_ODD_SHAPES = [(1, 1, 1, 1), (2, 5, 7, 9), (1, 33, 17, 40),
                  (100, 9, 9, 9)]


def _k15_exact_checks(got, x, w, b, kw):
    """K15's result `got`: the float64 sums' rounding bit for bit, a repeat
    bit for bit, the middle sample alone as in the batch."""
    assert torch.equal(got, conv3d_ndhwc_bf16_exact(x, w, b, **kw))
    assert torch.equal(got, conv3d.conv3d_ndhwc_bf16(x, w, b, **kw))
    i, r = x.shape[0] // 2, kw.get("residual")
    one = conv3d.conv3d_ndhwc_bf16(
        x[i:i + 1].clone(), w, b, pre_relu=kw.get("pre_relu", False),
        post_relu=kw.get("post_relu", False),
        residual=None if r is None else r[i:i + 1].clone())
    assert torch.equal(one[0], got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", K15_3X3_CASES)
@pytest.mark.parametrize("shape", K15_ODD_SHAPES)
def test_k15_equals_float64_sums_on_odd_shapes(card, dtype, case, shape):
    _, _, _, pre, post, _, _ = K15_CASES[case]
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    x, w, b, r = k15_inputs(gen, shape[0], shape[1:], case, dtype)
    kw = dict(pre_relu=pre, post_relu=post, residual=r)
    _k15_exact_checks(conv3d.conv3d_ndhwc_bf16(x, w, b, **kw), x, w, b, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k15_float32_residual_on_a_3x3_layer(card, dtype):
    gen = torch.Generator(device=card).manual_seed(15)
    x, w, b, _ = k15_inputs(gen, 3, (6, 7, 34), "block_a", dtype)
    r = torch.randn(3, 6, 7, 34, 32, generator=gen, device=card)
    kw = dict(pre_relu=True, post_relu=True, residual=r)
    got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
    assert got.dtype == torch.float32
    _k15_exact_checks(got, x, w, b, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k15_cancelling_sums_take_the_float64_path(card, dtype):
    # Channel pairs of equal inputs against weights a and -a, one in eight
    # of the latter nudged: the sums cancel to a small part of the sum of
    # |x||w|, so most outputs straddle a rounding point of their bound and
    # are summed in float64.
    from ffn_tpu_torch.ops.conv3d_bf16_check import conv_sums_f64
    gen = torch.Generator(device=card).manual_seed(16)
    x = torch.randn(4, 9, 10, 11, 16, generator=gen, device=card)
    x = x.repeat_interleave(2, dim=-1).to(dtype)
    a = torch.randn(3, 3, 3, 16, 32, generator=gen, device=card) * 0.05
    nudge = torch.rand(a.shape, generator=gen, device=card) < 0.125
    odd = torch.where(nudge, -a * (1 + 2.0 ** -6), -a)
    w = torch.stack([a, odd], dim=4).reshape(3, 3, 3, 32, 32).to(dtype)
    b = torch.zeros(32, dtype=dtype, device=card)
    s = conv_sums_f64(x, w)
    mag = conv_sums_f64(x, w, absolute=True)
    e = (mag * 2.0 ** -20 + s.abs() * 2.0 ** -22).float()
    sf = s.float()
    flagged = ((sf - e).to(dtype).view(torch.int16) !=
               (sf + e).to(dtype).view(torch.int16)).float().mean()
    assert float(flagged) > 0.3, float(flagged)
    _k15_exact_checks(conv3d.conv3d_ndhwc_bf16(x, w, b), x, w, b, {})


def _k17_inputs(card, dtype, case, n=2):
    gen = torch.Generator(device=card).manual_seed(17)

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=card) * scale).to(dtype)
    x, a, dy, acc = (randn(n, 33, 33, 33, 32, scale=sc)
                     for sc in (1.0, 1.0, 0.01, 0.01))
    if case == "conv_lom":
        return (randn(n, 33, 33, 33, 1, scale=0.01).float(),
                randn(1, 1, 1, 32, 1, scale=0.2), dict(x=x))
    w = randn(3, 3, 3, 32, 32, scale=(2 / 864) ** 0.5)
    return dy, w, dict(x=x, y=a, accum=acc) if case == "block_a" else {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("case", ["block_a", "block_b", "conv_lom"])
def test_k17_matches_plain(card, dtype, case):
    dy, w, kw = _k17_inputs(card, dtype, case)
    got = conv3d.conv3d_dgrad_16(dy, w, **kw)
    want = conv3d.conv3d_dgrad_16_plain(dy, w, **kw)
    assert got.dtype == dtype and torch.equal(
        got, conv3d.conv3d_dgrad_16(dy, w, **kw))
    if case == "conv_lom":   # one product per output: exact
        assert torch.equal(got, want)
        return
    # One ulp per rounding and 2^-20 of the sum of |w||g| (k17_tolerance).
    tol = k17_tolerance(dy, w, want, **kw)
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0
    # float16's finer ulp meets more rounding points (chip_smoke.py's
    # K17_DIFFER_SHARE).
    assert differ_share(got, want) <= {torch.bfloat16: 1e-3,
                                       torch.float16: 5e-3}[dtype]


# K17's 3^3 kernel on K15's tiles: shapes ending mid-tile, H = 1, W = 1,
# rows across tiles, N = 20 at 9^3 (several tiles a persistent CTA).
K17_SHAPES = [(1, 1, 1, 1), (2, 3, 1, 5), (1, 4, 5, 1), (2, 5, 7, 9),
              (1, 3, 17, 40), (2, 9, 10, 11), (20, 9, 9, 9)]


def _k17_args(card, dtype, case, shape, seed=171):
    gen = torch.Generator(device=card).manual_seed(seed + sum(shape))
    c = 16 if case == "16->16" else 32

    def randn(scale, *s):
        return (torch.randn(*s, generator=gen, device=card) * scale).to(dtype)
    x, a = randn(1.0, *shape, c), randn(1.0, *shape, c)
    dy, acc = randn(0.01, *shape, c), randn(0.01, *shape, c)
    w = randn((2 / (27 * c)) ** 0.5, 3, 3, 3, c, c)
    return dy, w, ({} if case == "block_b" else dict(x=x, y=a, accum=acc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("case", ["block_a", "block_b", "16->16"])
@pytest.mark.parametrize("shape", K17_SHAPES)
def test_k17_matches_plain_on_odd_shapes(card, dtype, case, shape):
    dy, w, kw = _k17_args(card, dtype, case, shape)
    got = _same_alone_and_again(conv3d.conv3d_dgrad_16, dy, w, kw)
    want = conv3d.conv3d_dgrad_16_plain(dy, w, **kw)
    tol = k17_tolerance(dy, w, want, **kw)
    assert got.dtype == dtype
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_k17_cancelling_sums_stay_in_bound(card, dtype):
    # g's channels in equal pairs against weights a and -a, one in eight of
    # the latter nudged: each sum cancels to a small part of the sum of
    # |w||g|, where only the 2^-20 term of the bound holds K17 to plain.
    gen = torch.Generator(device=card).manual_seed(172)
    dy = torch.randn(3, 9, 10, 11, 16, generator=gen, device=card)
    dy = (dy.repeat_interleave(2, dim=-1) * 0.01).to(dtype)
    a = torch.randn(3, 3, 3, 32, 16, generator=gen, device=card) * 0.05
    nudge = torch.rand(a.shape, generator=gen, device=card) < 0.125
    odd = torch.where(nudge, -a * (1 + 2.0 ** -6), -a)
    w = torch.stack([a, odd], dim=-1).reshape(3, 3, 3, 32, 32).to(dtype)
    got = _same_alone_and_again(conv3d.conv3d_dgrad_16, dy, w, {})
    want = conv3d.conv3d_dgrad_16_plain(dy, w)
    s = want.float().abs()
    mag = conv3d.conv3d_dgrad_plain(dy.float().abs(), w.float().abs())
    assert float((s / mag).median()) < 0.1   # the sums cancel
    tol = k17_tolerance(dy, w, want)
    assert float(((got.float() - want.float()).abs() / tol).max()) <= 1.0


@pytest.mark.cuda
def test_k17_refuses_rows_k15_refuses(card):
    # K17 runs on K15's tiles of g, so rows of 300 voxels, which K15's
    # forward of the layer refuses (test_k15_geometry_refuses_rows_too_wide),
    # raise here too.
    dy = torch.zeros(1, 2, 2, 300, 32, device=card, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 32, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3d.conv3d_dgrad_16(dy, w)
    conv3d.conv3d_dgrad_16(dy[..., :200, :].contiguous(), w)


# Which K18 body takes each layer of the stack (wgrad16_route): (k, Cin,
# Cout, x's type, dy's type, masked) -> the launch name's stem.
K18_ROUTES = {
    "conv0_a 2->32 float32 x": (3, 2, 32, torch.float32, "16", True,
                                "conv3d_wgrad"),
    "32->32": (3, 32, 32, "16", "16", False, "conv3d_wgrad"),
    "32->32 masked": (3, 32, 32, "16", "16", True, "conv3d_wgrad"),
    "16->16": (3, 16, 16, "16", "16", True, "conv3d_wgrad"),
    "ci conv0_a 2->16": (3, 2, 16, torch.float32, "16", True,
                         "conv3d_wgrad"),
    "conv_lom 1^3 float32 dy": (1, 32, 1, "16", torch.float32, False,
                                "conv3d_wgrad1"),
}


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("case", list(K18_ROUTES))
def test_k18_routes_by_shape_and_type(dtype, case):
    k, cin, cout, _, dyt, _, want = K18_ROUTES[case]
    dyt = dtype if dyt == "16" else dyt
    assert conv3d.wgrad16_route(k, cin, cout, dyt) == want


@pytest.mark.parametrize("layer", [(3, 32, 64, torch.bfloat16),
                                   (3, 40, 32, torch.bfloat16),
                                   (3, 32, 8, torch.float16),
                                   (3, 32, 32, torch.float32),
                                   (5, 32, 32, torch.bfloat16),
                                   (1, 80, 80, torch.bfloat16)])
def test_k18_route_refuses_other_layers(layer):
    with pytest.raises(ValueError):
        conv3d.wgrad16_route(*layer)


# The train CLI's batch, small and odd volumes, and the host loop's FOV
# batch (TrainConfig's batch_size 8), at the stack's widths.
@pytest.mark.parametrize("shape", [(4, 33, 33, 33), (1, 5, 7, 9),
                                   (3, 17, 33, 11), (8, 33, 33, 33)])
@pytest.mark.parametrize("widths", [(32, 32), (2, 32), (16, 16)])
def test_k18_chunks_cover_every_row_once(shape, widths):
    n, d, h, w = shape
    geo = conv3d.wgrad16_chunks(n, d, h, w, *widths)
    seen = np.zeros((n, d, h), np.int64)
    for c in range(geo.chunks):
        b, z0, z1, y0, y1 = geo.box(c)
        assert z0 < z1 <= z0 + geo.cz and y0 < y1 <= y0 + geo.cy
        seen[b, z0:z1, y0:y1] += 1
    assert (seen == 1).all()
    assert 1 <= geo.ctas <= min(geo.chunks, conv3d.WGRAD16_CTAS)
    assert geo.smem == conv3d.wgrad16_smem(geo.cz, geo.cy, w, *widths)
    assert geo.smem <= conv3d.WGRAD16_SMEM


def test_k18_chunks_shrink_to_fit_and_refuse_wide_rows():
    geo = conv3d.wgrad16_chunks(1, 8, 8, 160, 32, 32)
    assert (geo.cz, geo.cy) < conv3d.WGRAD16_CHUNK and \
        geo.smem <= conv3d.WGRAD16_SMEM
    with pytest.raises(ValueError):
        conv3d.wgrad16_chunks(1, 8, 8, 4000, 32, 32)


K18_CASES = ["block_a", "block_b", "conv0_a", "conv_lom", "n1",
             "odd_small", "16->16", "all_masked", "cancelling"]


def _k18_args(card, dtype, case):
    """((x, dy, k), kwargs) of a test_k18_matches_plain case."""
    if case in ("block_a", "block_b", "conv0_a", "conv_lom"):
        dy, w, kw = _k17_inputs(card, dtype, "block_a")
        x, a = kw["x"], kw["y"]
        return {"block_a": ((x, dy, 3), dict(pre_relu=True, y=a)),
                "block_b": ((a, dy, 3), {}),
                "conv0_a": ((x[..., :2].float().contiguous(), dy, 3),
                            dict(y=a)),
                "conv_lom": ((x, dy[..., :1].float().contiguous(), 1),
                             dict(pre_relu=True))}[case]
    gen = torch.Generator(device=card).manual_seed(18)
    shape, c = {"n1": ((1, 33, 33, 33), 32), "odd_small": ((2, 2, 1, 5), 32),
                "16->16": ((1, 5, 7, 9), 16), "all_masked": ((1, 6, 5, 7),
                                                             32),
                "cancelling": ((1, 9, 8, 7), 32)}[case]

    def randn(scale=1.0):
        return (torch.randn(*shape, c, generator=gen, device=card)
                * scale).to(dtype)
    x, a, dy = randn(), randn(), randn(0.01)
    if case == "all_masked":   # no y > 0 (NaN counts as not): g is 0
        a = -a.abs()
        a.view(-1)[::7] = float("nan")
    if case == "cancelling":   # sample 1 = sample 0 with dy negated
        return ((torch.cat([x, x]), torch.cat([dy, -dy]), 3), {})
    return (x, dy, 3), dict(pre_relu=True, y=a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("case", K18_CASES)
def test_k18_matches_plain(card, dtype, case):
    from ffn_tpu_torch.ops.conv3d_bf16_check import bf16_ulp
    args, kw = _k18_args(card, dtype, case)
    gw, gb = conv3d.conv3d_wgrad_16(*args, **kw)
    pw, pb = conv3d.conv3d_wgrad_16_plain(*args, **kw)
    mw, mb = conv3d.conv3d_wgrad_plain(
        *(t.to(dtype).float().abs() for t in args[:2]), args[2],
        y=kw["y"].float() if "y" in kw else None)
    for g, p, m in ((gw, pw, mw), (gb, pb, mb)):
        assert g.dtype == torch.float32
        assert bool(((g - p).abs() <= bf16_ulp(p, dtype)
                     + m * 2.0 ** -16).all())
    if case == "all_masked":
        assert not gw.any() and not gb.any()
    again = conv3d.conv3d_wgrad_16(*args, **kw)
    assert torch.equal(again[0], gw) and torch.equal(again[1], gb)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [None, float("inf"), float("nan")])
def test_k12_with_the_loss_scale_matches_plain(card, bad):
    from ffn_tpu_torch.training import precision
    rng = np.random.RandomState(121)
    shapes = [(3, 3, 3, 4, 8), (8,), (1, 1, 1, 8, 1), (1,)]
    h = optim_ops.Hyper("sgd", 0.05)
    kp = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
          for s in shapes]
    pp = [t.clone() for t in kp]
    scales = [precision.DynamicLossScale.init(2.0 ** 15, growth_interval=2,
                                              device=card) for _ in "kp"]
    flags = [torch.zeros((), dtype=torch.bool, device=card) for _ in "kp"]
    none, one = [None] * len(kp), torch.tensor(1.0, device=card)
    for step in range(4):
        grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)
                                  * 2 ** 15).to(card) for s in shapes]
        if bad is not None and step == 2:
            grads[0].view(-1)[9] = bad
        optim_ops.optim_update(kp, grads, none, none, None, h, None, None,
                               one, flags[0], optim_ops.ctrl_buffer(card),
                               loss_scale=scales[0])
        optim_ops.optim_update_plain(pp, grads, none, none, None, h, None,
                                     None, one, flags[1],
                                     loss_scale=scales[1])
        assert torch.equal(flags[0], flags[1])
        assert torch.equal(scales[0].scale, scales[1].scale)
        assert torch.equal(scales[0].counter, scales[1].counter)
        assert all(torch.equal(a, b) for a, b in zip(kp, pp))
    assert float(scales[0].scale) == 2.0 ** (15 if bad is not None else 17)


# -- int8 inference: K19 qconv3d_s8, K20 act_absmax ------------------------

# Every int8 layer kind of model-r2 and of the CI checkpoint: (k, Cin,
# Cout, relu_in, relu_out, residual).
K19_CASES = {"conv0_a": (3, 2, 32, False, True, False),
             "block_a": (3, 32, 32, True, True, False),
             "block_b": (3, 32, 32, False, False, True),
             "conv_lom": (1, 32, 1, True, False, True),
             "ci_conv0_a": (3, 2, 16, False, True, False),
             "ci_block_b": (3, 16, 16, True, False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K19_CASES))
@pytest.mark.parametrize("n", [1, 7, 64])
def test_k19_k20_match_plain_bit_for_bit(card, case, n):
    # Lanes of magnitudes 1e-2 to 1e2 on the 33^3 FOV, lane 3 all zero.
    from ffn_tpu_torch.ops import quantized
    k, cin, cout, relu_in, relu_out, res = K19_CASES[case]
    rng = np.random.RandomState(n)
    layer = quantized.fold_convstack_params({"c": {
        "kernel": rng.randn(k, k, k, cin, cout).astype(np.float32) * 0.05,
        "bias": rng.randn(cout).astype(np.float32)}})["c"].to(card)
    mag = 10.0 ** rng.randint(-2, 3, (n, 1, 1, 1, 1))
    x = torch.from_numpy((rng.randn(n, 33, 33, 33, cin) * mag).astype(
        np.float32)).to(card)
    if n > 3:
        x[3] = 0
    r = torch.randn(n, 33, 33, 33, cout, device=card) if res else None
    am = quantized.act_absmax(x, relu_in)
    assert torch.equal(am, quantized.act_absmax_plain(x, relu_in))
    kw = dict(relu_in=relu_in, relu_out=relu_out, residual=r)
    got = quantized.qconv3d(x, layer, am, **kw)
    assert torch.equal(got, quantized.qconv3d_plain(x, layer, am, **kw))
    assert torch.equal(quantized.qconv3d(x[:1], layer, am[:1], **dict(
        kw, residual=r[:1] if res else None)), got[:1])


@pytest.mark.cuda
def test_int8_cuda_tensors_never_reach_the_plain_versions(card, monkeypatch):
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import quantized

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(quantized, "qconv3d_plain", refuse)
    monkeypatch.setattr(quantized, "act_absmax_plain", refuse)
    model = quantized.QuantizedConvStack3DModel(
        convstack_3d.ConvStack3DFFNModel(fov_size=[9] * 3, deltas=[2] * 3,
                                         depth=2, features=16))
    model.prepare()
    model.to(card)
    _build.launches.clear()
    out = model.apply(torch.randn(2, 9, 9, 9, 1, device=card),
                      torch.randn(2, 9, 9, 9, 1, device=card))
    torch.cuda.synchronize()
    assert out.shape == (2, 9, 9, 9, 1) and bool(out.isfinite().all())
    assert _build.launches["qconv3d_s8"] == _build.launches["act_absmax"] == 5


# K19's 3^3 kernel across its plan (quantized.k19_geometry): N = 1, 3, 64
# at every width, on the FOV and odd volumes (rows wider than a band, one
# voxel); the flags vary with the shape. Bit for bit with plain, the first
# and last lanes alone as in the batch.
K19_SHAPES = [(33, 33, 33), (5, 7, 9), (3, 5, 200), (1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(2, 32), (32, 32), (2, 16), (16, 16)])
@pytest.mark.parametrize("shape", K19_SHAPES)
@pytest.mark.parametrize("n", [1, 3, 64])
def test_k19_matches_plain_across_its_plan(card, n, shape, widths):
    from ffn_tpu_torch.ops import quantized
    cin, cout = widths
    rng = np.random.RandomState(n + sum(shape) + cin + cout)
    relu_in, relu_out, res = cin > 2, shape[0] % 2 == 1, cin == cout
    layer = quantized.fold_convstack_params({"c": {
        "kernel": rng.randn(3, 3, 3, cin, cout).astype(np.float32) * 0.05,
        "bias": rng.randn(cout).astype(np.float32)}})["c"].to(card)
    mag = 10.0 ** rng.randint(-2, 3, (n, 1, 1, 1, 1))
    x = torch.from_numpy((rng.randn(n, *shape, cin) * mag).astype(
        np.float32)).to(card)
    if n > 1:
        x[n // 2] = 0
    r = torch.randn(n, *shape, cout, device=card) if res else None
    am = quantized.act_absmax(x, relu_in)
    kw = dict(relu_in=relu_in, relu_out=relu_out, residual=r)
    got = quantized.qconv3d(x, layer, am, **kw)
    assert torch.equal(got, quantized.qconv3d_plain(x, layer, am, **kw))
    for i in (0, n - 1):
        one = quantized.qconv3d(x[i:i + 1].clone(), layer, am[i:i + 1],
                                **dict(kw, residual=None if r is None
                                       else r[i:i + 1].clone()))
        assert torch.equal(one[0], got[i])


# K20's reads (quantized.k20_reads, mirrored from qconv3d.cu): each lane's
# float4s split over its blocks, the floats before its first 16-byte
# boundary and after its last float4 in its first block's; lanes of
# 33^3 * 2 floats start unaligned every other lane.
@pytest.mark.parametrize("cin", [2, 32])
@pytest.mark.parametrize("n", [1, 3, 64])
@pytest.mark.parametrize("start", [0, 1, 2, 3])
def test_k20_reads_cover_every_element_once(cin, n, start):
    from ffn_tpu_torch.ops import quantized
    per_lane = 33 ** 3 * cin
    blocks = quantized.k20_blocks(per_lane, n)
    # About two waves of 8 blocks a SM at most, at least one pass a lane.
    assert blocks * n <= 2 * 8 * quantized.H100_SMS + n
    for lane in sorted({0, 1, n - 1}):
        reads = quantized.k20_reads(per_lane, n, lane,
                                    start + lane * per_lane)
        assert [blk for blk, _ in reads] == list(range(blocks))
        seen = np.zeros(per_lane, np.int64)
        for _, idx in reads:
            np.add.at(seen, idx, 1)
        assert (seen == 1).all()
        head = (4 - (start + lane * per_lane) % 4) % 4
        assert list(reads[0][1][:head]) == list(range(head))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("cin", [2, 32])
def test_k20_model_equals_the_jax_lane_absmax(relu, cin):
    # Bit for bit the JAX package's per-lane abs-max
    # (_dyn_quantize_activation's jnp.maximum(jnp.max(jnp.abs(x)), 1e-12)
    # under jax.vmap, on the relu'd input where the layer has pre_relu):
    # lanes of magnitudes 1e-2 to 1e2, one all zero with a -0, one all
    # negative (relu: the floor), an unaligned lane start.
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from ffn_tpu_torch.ops import quantized
    rng = np.random.RandomState(cin + relu)
    n = 4
    x = (rng.randn(n, 33, 33, 33, cin)
         * 10.0 ** rng.randint(-2, 3, (n, 1, 1, 1, 1))).astype(np.float32)
    x[1] = 0
    x[1, 3, 4, 5, 0] = -0.0
    x[2] = -np.abs(x[2]) - 1e-3
    xin = np.maximum(x, 0) if relu else x
    want = np.asarray(jax.vmap(
        lambda v: jnp.maximum(jnp.max(jnp.abs(v)), 1e-12))(jnp.asarray(xin)))
    for start in (0, 1):
        got = quantized.act_absmax_model(x.reshape(n, -1), relu, start)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    plain = quantized.act_absmax_plain(torch.from_numpy(x), relu).numpy()
    assert np.array_equal(plain.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [2, 32])
@pytest.mark.parametrize("n", [1, 3, 64])
def test_k20_one_launch_a_call_bit_for_bit(card, cin, n):
    # Two calls back to back on one buffer, both relu flags, an unaligned
    # view: each equal to the plain version bit for bit, one launch a call,
    # the buffer zero again after each.
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import quantized
    rng = np.random.RandomState(20 + n + cin)
    x = (rng.randn(n, 33, 33, 33, cin)
         * 10.0 ** rng.randint(-2, 3, (n, 1, 1, 1, 1))).astype(np.float32)
    if n > 1:
        x[1] = 0
    xs = torch.from_numpy(x).to(card)
    flat = torch.zeros(x.size + 1, device=card)
    flat[1:] = xs.reshape(-1)
    shifted = flat[1:].view(xs.shape)   # 4 bytes past the allocation
    for relu in (False, True):
        before = _build.launches[quantized.ABSMAX]
        got = [quantized.act_absmax(t, relu) for t in (xs, xs, shifted)]
        torch.cuda.synchronize()
        assert _build.launches[quantized.ABSMAX] == before + 3
        want = quantized.act_absmax_plain(xs, relu)
        assert all(torch.equal(g, want) for g in got)
        for work in quantized._ABSMAX_WORK.values():
            assert not bool(work.any())



# -- K21 layernorm_channels, K22 edges_sobel, K23 edges_blur ------------------

from ffn_tpu_torch.ops import image as image_ops  # noqa: E402
from ffn_tpu_torch.ops import layernorm as ln_ops  # noqa: E402

HALF_AND_F32 = (torch.float32, torch.bfloat16, torch.float16)
# Volumes for K22/K23: an axis shorter than the Gaussian's 33-voxel pad
# (reflected more than once), a single-voxel axis, ragged tiles.
EDGE_SHAPES = [(20, 40, 70), (1, 9, 11), (33, 35, 37)]


def test_k21_rejects_bad_inputs():
    # On the CPU too: the wrapper refuses what the kernel does not take
    # before it dispatches (a `meta` tensor stands in for another device).
    x = torch.zeros(1, 4, 4, 4, 8)
    s, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError):      # float64 storage
        ln_ops.layernorm_channels(x.double(), s, b)
    with pytest.raises(TypeError):      # a 16-bit scale
        ln_ops.layernorm_channels(x, s.bfloat16(), b)
    with pytest.raises(ValueError):     # channel mismatch
        ln_ops.layernorm_channels(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError):     # not contiguous
        ln_ops.layernorm_channels(x.transpose(1, 2), s, b)
    with pytest.raises(ValueError):     # parameters on another device
        ln_ops.layernorm_channels(x, s.to("meta"), b)
    assert ln_ops.layernorm_channels(x.half(), s, b).dtype == torch.float16


def test_k22_k23_reject_bad_inputs():
    vol, taps = torch.zeros(4, 5, 6), image_ops.gaussian_taps()
    with pytest.raises(TypeError):      # float64
        image_ops.edges_sobel(vol.double())
    with pytest.raises(ValueError):     # not 3-d
        image_ops.edges_sobel(torch.zeros(4, 5))
    with pytest.raises(ValueError):     # not contiguous
        image_ops.edges_sobel(vol.transpose(0, 2))
    with pytest.raises(TypeError):      # float64 taps
        image_ops.edges_blur(vol, taps.double(), 0)
    with pytest.raises(ValueError):     # an even number of taps
        image_ops.edges_blur(vol, taps[:-1], 0)
    with pytest.raises(ValueError):     # more taps than K23's tile holds
        image_ops.edges_blur(vol, torch.ones(313), 0)
    with pytest.raises(ValueError):     # no such axis
        image_ops.edges_blur(vol, taps, 3)
    with pytest.raises(ValueError):     # edges of another shape
        image_ops.edges_blur(vol, taps, 2, edges=torch.zeros(4, 5, 7))
    with pytest.raises(ValueError):     # not contiguous
        image_ops.edges_blur(vol.transpose(0, 1), taps, 0)
    with pytest.raises(ValueError):     # taps on another device
        image_ops.edges_blur(vol, taps.to("meta"), 0)


def _ln_inputs(gen, dev, dtype, c, shape=(2, 9, 10, 11)):
    x = torch.randn(*shape, c, generator=gen, device=dev)
    # Voxels far from 0 with a small spread, where E[x^2] - mean^2 cancels
    # (and may fall below 0, clamped), and constant voxels.
    x[0, :3] = x[0, :3] * 1e-3 + 100.0
    x[1, :2] = 2.5
    scale = 1.0 + 0.5 * torch.randn(c, generator=gen, device=dev)
    bias = 0.3 * torch.randn(c, generator=gen, device=dev)
    return x.to(dtype), scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_AND_F32)
@pytest.mark.parametrize("c", [8, 32, 64])
def test_k21_matches_plain(card, dtype, c):
    gen = torch.Generator(device=card).manual_seed(c)
    x, scale, bias = _ln_inputs(gen, card, dtype, c)
    got = ln_ops.layernorm_channels(x, scale, bias)
    want = ln_ops.layernorm_channels_plain(x, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_k22_k23_match_plain_bit_for_bit(card, shape):
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    img = torch.randn(*shape, generator=gen, device=card) * 40 + 128
    taps = image_ops.gaussian_taps(device=card)
    mag = image_ops.edges_sobel(img)
    assert torch.equal(mag, image_ops.edges_sobel_plain(img))
    x = mag
    for axis in range(3):
        got = image_ops.edges_blur(x, taps, axis)
        assert torch.equal(got, image_ops.edges_blur_plain(x, taps, axis))
        x = got
    mask = image_ops.edges(img)
    torch.cuda.synchronize()
    assert torch.equal(mask, mag > x)
    assert torch.equal(mask, image_ops.edges_plain(img))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2.0 ** -6)])
def test_resconvstack_kernels_match_plain(card, dtype, tol):
    from unittest import mock
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    torch.manual_seed(0)
    model = convstack_3d.ResConvStack(depth=3, features=16,
                                      compute_dtype=dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn_like(p) * (2.0 / p[..., 0].numel()) ** .5)
            elif name.startswith("ln"):
                p.copy_(torch.randn_like(p) * 0.3 + (name.endswith("scale")))
    model.round_params()
    model.to(card)
    x = torch.randn(2, 12, 12, 12, 2, device=card)
    _build.launches.clear()
    with torch.no_grad():
        got = model(x)
        assert _build.launches[ln_ops.NAME] == 2
        with mock.patch.object(convstack_3d, "layernorm_channels",
                               ln_ops.layernorm_channels_plain), \
                mock.patch.object(convstack_3d, "conv3d_ndhwc_f32",
                                  conv3d.conv3d_ndhwc_plain), \
                mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                                  conv3d.conv3d_ndhwc_bf16_plain):
            want = model(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, 12, 12, 12, 1)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
