"""K8's pass order (csrc/finalize.cu) as a numpy model, held to
`finalize_pass_plain` on the CPU.

The kernel runs the JAX program's sequential pass in another order: the
lane masks as 32-bit words (lowest set bit first), the FIFO examined 32
entries a step, the pop and the next lane's verdicts made beside the turn's
id write (each voxel tested against the segmentation as that write leaves
it, whether or not a block has written it yet: the model reads each such
voxel before or after the write at random), and each reseed's blank, init
activation and dedup clear deferred to the next turn. The model follows
that order on numpy copies; every field must equal the plain pass's, NaN
for NaN, on crafted states at three seeds (and bfloat16 seeds) and on
random states that hit the in-turn FIFO case, the claimed runs and several
mask words.
"""

import numpy as np
import pytest
import torch

from ffn_tpu_torch.ops import finalize as fin_ops
from test_torch_kernels import (FOV, MOVE_T, MOVE_T_LO, SHAPE,
                                bf16_finalize_edges, crafted_finalize,
                                finalize_step, random_finalize, to_torch)

torch.set_num_threads(1)

IDLE, RUNNING, DONE_EMPTY, DONE_WEAK, DONE_CAP = 0, 1, 2, 3, 4
DONE_FINALIZED = fin_ops.DONE_FINALIZED


def _low_bit(word):
    return (int(word) & -int(word)).bit_length() - 1


def _clamp_start(start, dim, size):
    start = start + dim if start < 0 else start
    return max(0, min(start, dim - size))


def _after_write(seg, blk, pending, seed, seg_t, sid):
    """csrc/finalize.cu's after_write."""
    in_mask = seed >= seg_t and seg == 0 and not blk & 1
    return sid if pending and in_mask else seg


def model_pass(lanes, fin, blocked, opts, rng, *, move_threshold, max_iters,
               fov, deltas, bf16, stats):
    """K8's pass on the numpy state, in place; returns alive. `stats`
    counts the pops and verdicts that the turn's pending write decided."""
    dummy = torch.empty(0, dtype=torch.bfloat16 if bf16 else torch.float32)
    seg_t, min_size, init_act = fin_ops._fin_values(opts, dummy)
    move_t = float(np.float32(move_threshold))
    verdict_t = fin_ops._verdict_threshold(move_threshold, dummy)
    seeds, seg = lanes["seeds"], fin["seg"]
    B, dims = seeds.shape[0], seeds.shape[1:]
    K, L = seg.shape[0], fin["log"].shape[0]
    block, off0, _ = fin_ops.blank_geometry((fov,) * 3, (fov,) * 3, deltas,
                                            dims)
    pred = (fov,) * 3
    status = lanes["status"]

    # The dud kill and the cond, a thread a lane; the masks as bit words.
    nmask = [0] * 32
    rmask = [0] * 32
    any_running = any_n = any_r = False
    for b in range(B):
        st = int(status[b])
        running = st == RUNNING
        capped = running and max_iters > 0 and lanes["iters"][b] >= max_iters
        weak_now = False
        if running and not capped and not lanes["fresh"][b]:
            origin = seeds[(b,) + tuple(lanes["start"][b])]
            weak_now = not origin >= move_t
        st = DONE_CAP if capped else DONE_WEAK if weak_now else st
        status[b] = st
        n = (st == DONE_EMPTY and not fin["hold"][b]) or st in (DONE_WEAK,
                                                                 DONE_CAP)
        r = st in (IDLE, DONE_FINALIZED)
        nmask[b >> 5] |= int(n) << (b & 31)
        rmask[b >> 5] |= int(r) << (b & 31)
        any_running |= running
        any_n |= n
        any_r |= r
    fifo_n, head = int(fin["fifo_n"]), int(fin["fifo_head"])
    work = any_n or (any_r and head < fifo_n)
    if not work:
        return any_running
    entry_status = status.copy()

    def choose():
        for w in range(32):
            if nmask[w]:
                return 32 * w + _low_bit(nmask[w])
        if head < fifo_n:
            for w in range(32):
                if rmask[w]:
                    return 32 * w + _low_bit(rmask[w])
        return -1

    def read_seg(k, at, pend):
        """A seg read beside the turn's write: before it or after it."""
        if pend is not None and k == pend["slot"] and rng.rand() < 0.5:
            return int(pend["post"][at])
        return int(seg[(k,) + at])

    def prepare(li, pend):
        c = dict(li=li, cand=False, sv=0, sid=0)
        if li < 0:
            return c
        c.update(sv=int(lanes["sv"][li]), s=lanes["start"][li].tolist(),
                 lo=lanes["minp"][li].copy(), hi=lanes["maxp"][li].copy(),
                 status=int(entry_status[li]), iters=int(lanes["iters"][li]),
                 weak=False, claimed_at=False)
        c["do_fin"] = c["status"] in (DONE_EMPTY, DONE_WEAK, DONE_CAP)
        c["invalid"] = c["iters"] <= 0
        c["sid"] = int(fin["next_sid"][c["sv"]])
        if c["do_fin"]:
            at = tuple(c["s"])
            k = c["sv"]
            pending = pend is not None and k == pend["slot"]
            seg0 = read_seg(k, at, pend)
            blk = int(blocked[(k,) + at])
            after = _after_write(seg0, blk, pending,
                                 pend["seed"][at] if pending else 0.0, seg_t,
                                 pend["id"] if pending else 0)
            stats["verdicts"] += int(after != int(seg[(k,) + at]))
            c["weak"] = (c["status"] == DONE_WEAK
                         or not seeds[(li,) + at] >= verdict_t)
            c["claimed_at"] = after > 0 or bool(blk & 1)
            c["cand"] = not c["invalid"] and not c["weak"] and \
                not c["claimed_at"]
        return c

    cur = prepare(choose(), None)
    pub = dict(lane=cur["li"], cand=cur["cand"], slot=cur["sv"],
               sid=cur["sid"], prev=-1)
    log_n = int(fin["log_n"])
    while True:
        # The previous turn's blank, init activation and dedup clear.
        prev = pub["prev"]
        if prev >= 0:
            hit = pub["hit"]
            if pub["small"]:
                box = tuple(slice(c, c + b) for c, b in zip(pub["corner"],
                                                            block))
                seeds[(prev,) + box] = np.nan
            else:
                seeds[prev] = np.nan
            if hit is not None:
                seeds[(prev,) + hit] = init_act
            lanes["done"][prev] = 0
        lane = pub["lane"]
        if lane < 0:
            break

        # The count; the write's result, applied after the leader's reads.
        slot, sid = pub["slot"], pub["sid"]
        lseed = seeds[lane]
        mask = ((lseed >= seg_t) & (seg[slot] == 0)
                & ((blocked[slot] & 1) == 0))
        nvox = int(mask.sum()) if pub["cand"] else 0
        ok = pub["cand"] and nvox >= min_size
        pend = dict(slot=slot, seed=lseed, id=sid,
                    post=np.where(mask, sid, seg[slot])) if ok else None

        li = cur["li"]
        assert li == lane
        if ok:
            fin["next_sid"][cur["sv"]] = cur["sid"] + 1
        if cur["do_fin"]:
            outcome = (fin_ops.FIN_INVALID if cur["invalid"] else
                       fin_ops.FIN_SEGMENTED if ok else
                       fin_ops.FIN_WEAK if cur["weak"] else
                       fin_ops.FIN_CLAIMED if cur["claimed_at"] else
                       fin_ops.FIN_TOO_SMALL)
            fin["log"][min(log_n, L - 1)] = [
                cur["sv"], sid if ok else 0, *cur["s"], cur["iters"], nvox,
                cur["status"], outcome, li]
            log_n += 1

        # The FIFO, 32 entries a step.
        got, pos2, sv2 = False, None, None
        while head < fifo_n:
            ents = list(range(head, min(head + 32, fifo_n)))
            free = []
            for e in ents:
                csv = int(fin["fifo_sv"][e])
                k = min(max(csv, 0), K - 1)
                at = tuple(min(max(int(v), 0), d - 1)
                           for v, d in zip(fin["fifo_pos"][e], dims))
                blk = int(blocked[(k,) + at])
                pending = ok and k == slot
                after = _after_write(read_seg(k, at, pend), blk, pending,
                                     lseed[at] if pending else 0.0, seg_t,
                                     sid)
                stats["pops"] += int(after != int(seg[(k,) + at]))
                free.append(after == 0 and not blk & 1)
            first = free.index(True) if True in free else 32
            for j, e in enumerate(ents[:first]):
                k = int(fin["fifo_sv"][e])
                if 0 <= k < K:
                    fin["claimed"][k] += 1
            if True in free:
                got = True
                pos2 = fin["fifo_pos"][head + first].tolist()
                sv2 = int(fin["fifo_sv"][head + first])
                head += first + 1
                break
            head = min(head + 32, fifo_n)
        nmask[li >> 5] &= ~(1 << (li & 31))
        rmask[li >> 5] &= ~(1 << (li & 31))
        nxt = prepare(choose(), pend)
        if ok:
            seg[slot] = pend["post"]

        # Lane li's fields now; its blank with the next turn.
        pub = dict(lane=nxt["li"], cand=nxt["cand"], slot=nxt["sv"],
                   sid=nxt["sid"], prev=li if got else -1)
        if got:
            span = cur["hi"] - cur["lo"]
            pub["small"] = all(span[a] <= block[a] - pred[a]
                               for a in range(3))
            pub["corner"] = [_clamp_start(int(cur["lo"][a]) + off0[a],
                                          dims[a], block[a])
                             for a in range(3)]
            inside = all(0 <= v < d for v, d in zip(pos2, dims))
            pub["hit"] = tuple(pos2) if inside else None
            lanes["qpos"][li, 0] = pos2
            lanes["qscore"][li, 0] = np.float32(2.0) * np.abs(
                np.float32(move_threshold)) + np.float32(1.0)
            lanes["sv"][li] = sv2
            lanes["head"][li], lanes["tail"][li] = 0, 1
            lanes["start"][li] = lanes["minp"][li] = lanes["maxp"][li] = pos2
        lanes["iters"][li] = 0
        status[li] = RUNNING if got else DONE_FINALIZED
        lanes["fresh"][li] = got
        cur = nxt
    fin["fifo_head"][...] = head
    fin["log_n"][...] = log_n
    return any_running or work


def _check(lanes, fin, blocked, opts, *, move_threshold=MOVE_T, max_iters=5,
           fov=FOV, bf16=False, passes=2, seed=0):
    """The model and the plain pass from the same state, `passes` passes;
    returns the model's stats."""
    rng = np.random.RandomState(seed)
    plain = (to_torch(lanes, "cpu"), to_torch(fin, "cpu"))
    model = ({k: v.copy() for k, v in lanes.items()},
             {k: np.array(v, copy=True) for k, v in fin.items()})
    if bf16:
        plain[0]["seeds"] = plain[0]["seeds"].to(torch.bfloat16)
        model[0]["seeds"] = plain[0]["seeds"].float().numpy().copy()
    stats = dict(pops=0, verdicts=0)
    kw = dict(move_threshold=move_threshold, max_iters=max_iters)
    for turn in range(passes):
        want = finalize_step(fin_ops.finalize_pass_plain, *plain,
                             torch.from_numpy(blocked), opts, fov=fov,
                             deltas=(2, 2, 2), **kw)
        got = model_pass(*model, blocked, opts, rng, fov=fov,
                         deltas=(2, 2, 2), bf16=bf16, stats=stats, **kw)
        assert int(want[0]) == int(got), f"alive, pass {turn}"
        for p, m in zip(plain, model):
            for name, t in p.items():
                np.testing.assert_array_equal(
                    m[name], t.float().numpy() if name == "seeds" else
                    t.numpy(), err_msg=f"{name}, pass {turn}")
    return stats


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_model_matches_plain_on_crafted_states(seed):
    rng = np.random.RandomState(seed)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    _check(lanes, fin, blocked, opts, seed=seed)


def test_model_matches_plain_on_bf16_seeds():
    rng = np.random.RandomState(18)
    lanes, fin, blocked, opts = crafted_finalize(
        rng, 24, 2, SHAPE, 64, 24, FOV, (2, 2, 2), 5, 20)
    bf16_finalize_edges(rng, lanes, fin, opts, MOVE_T_LO)
    _check(lanes, fin, blocked, opts, move_threshold=MOVE_T_LO, bf16=True)


@pytest.mark.parametrize("min_size", [1, 10 ** 6])
def test_model_in_turn_candidates(min_size):
    # The FIFO's head on lane 0's mask and lane 1's origin inside it: the
    # turn's pending write decides both when it writes (min_size 1).
    rng = np.random.RandomState(52)
    lanes, fin, blocked, opts = random_finalize(
        rng, 16, 2, SHAPE, 24, min_size=min_size, in_turn=3)
    stats = _check(lanes, fin, blocked, opts, seed=min_size)
    if min_size == 1:
        assert stats["pops"] >= 3 and stats["verdicts"] >= 1


@pytest.mark.parametrize("B,shape,claimed_run,fov", [
    (70, SHAPE, 70, FOV), (1, SHAPE, 0, FOV), (33, (11, 9, 13), 5, FOV),
    (1024, (12, 13, 14), 40, FOV), (6, (33, 33, 33), 2, 33),
    (6, (41, 48, 57), 2, 33)])
def test_model_on_random_states(B, shape, claimed_run, fov):
    rng = np.random.RandomState(B + sum(shape))
    lanes, fin, blocked, opts = random_finalize(
        rng, B, 3, shape, max(8, B // 2, claimed_run + 8),
        claimed_run=claimed_run, in_turn=2)
    _check(lanes, fin, blocked, opts, fov=fov, seed=B)
