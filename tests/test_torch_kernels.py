"""ffn_tpu_torch's CUDA kernels against their plain PyTorch versions.

The `cuda` tests need an NVIDIA card (a CUDA kernel has no CPU mode) and
skip without one; on the card, run

  python -m pytest tests/test_torch_kernels.py -q

This file imports torch and the port only, so it runs where JAX's model
libraries are not installed. K1 is held to 1e-4 of max|plain| (float32
sums in another order than cuDNN's, TF32 off on both sides); K2 and K3
move and compare values without arithmetic and must match bit for bit.
"""

import numpy as np
import pytest
import torch

from ffn_tpu_torch.ops import conv3d
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
