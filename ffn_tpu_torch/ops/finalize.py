"""K8 `finalize_pass`: device finalization of finished lanes.

Counterpart of `finalize_pass`/`finalize_one` in the JAX multi-hop
program (ffn_tpu/inference/hop_engine.py:624-864), run at each hop's entry
and after its update in device-finalize mode. One pass: (1) the same-hop
dud kill (:828-840: capped RUNNING lanes DONE_CAP, those whose origin fell
below the move threshold DONE_WEAK, NaN weak); (2) a sequential loop
(:847-863) over the lowest-index finishable lane, then IDLE or
DONE_FINALIZED lanes while the FIFO holds entries; (3) finalize_one:
verdicts weak -> invalid -> seed-claimed -> too small (:647-689), the
masked count over the lane's slot, the id written, next_sid[sv]
incremented; (4) the log row (:690-696, at a row clamped to L - 1); (5)
FIFO pops against the updated segmentation (:703-727, skips counted per
slot) and the reseed (:729-802: the NaN blank, small block or whole
buffer, the init activation, the cleared dedup grid).

The loop is sequential by design (each claim decides the next verdicts).
CUDA tensors launch `csrc/finalize.cu`, CPU tensors run
`finalize_pass_plain`, the oracle; both update state in place. With
bfloat16 seeds both copy the JAX program, which treats one origin two ways
in one pass: the dud kill against the unrounded float32 move threshold
(:835-836), the verdict against it rounded to bfloat16 (:650), so a
RUNNING lane with bf16(move_t) <= v < move_t dies weak while a DONE_EMPTY
lane with the same v is finalized; the claim mask against the segment
threshold rounded (:662); blank and activation stored rounded (:747-767).
Launches count as "finalize_pass_bf16".
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops import hop as hop_ops

NAME = "finalize_pass"

DONE_FINALIZED = 6   # finalized in kernel with an empty FIFO: the lane idles

# Outcome codes of the log rows (hop_engine.py:60-64).
FIN_SEGMENTED = 1
FIN_WEAK = 2
FIN_TOO_SMALL = 3
FIN_CLAIMED = 4
FIN_INVALID = 5

LOG_COLUMNS = 10   # [sv, sid, z, y, x, iters, voxels, status, outcome, lane]

# The kernel keeps the lane masks in shared memory.
MAX_LANES = 1024

# K8's scratch (csrc/finalize.cu, kScratchInts): the grid barrier's count
# and generation and two turn buffers, zeroed once a (device, stream); the
# kernel leaves it ready for the next call, so a call is one launch. Calls
# on one stream run one after another and never share it at once; the port
# launches K8 on the current stream only.
SCRATCH_INTS = 96
_SCRATCH: dict = {}


# The kernel's scalar arguments by the shapes and options they come from:
# a call recomputes none of them (the wrapper's host time, PERF.md).
_SCALARS: dict = {}


def _kernel_scalars(state, fstate, fin_opts, move_threshold, max_iters,
                    pred_size, seed_size, deltas) -> tuple:
    """ffn_finalize_pass's arguments from B to bf16: the shapes, the blank's
    geometry, the iteration cap and the thresholds as the kernel reads them
    (`_fin_values`, `_verdict_threshold`)."""
    seeds = state.seeds
    key = (seeds.dtype, seeds.shape, state.qpos.shape[1], fstate.seg.shape[0],
           state.done.shape, fstate.log.shape[0],
           np.asarray(fin_opts, np.float32).tobytes(), float(move_threshold),
           int(max_iters), tuple(pred_size), tuple(seed_size), tuple(deltas))
    scalars = _SCALARS.get(key)
    if scalars is None:
        seg_t, min_size, init_act = _fin_values(fin_opts, seeds)
        B, *dims = seeds.shape
        block, off0, _ = blank_geometry(pred_size, seed_size, deltas, dims)
        scalars = (B, state.qpos.shape[1], fstate.seg.shape[0], *dims,
                   int(np.prod(state.done.shape[1:])), fstate.log.shape[0],
                   *(int(v) for v in pred_size), *block, *off0,
                   int(max_iters), min_size, float(np.float32(move_threshold)),
                   _verdict_threshold(move_threshold, seeds), seg_t, init_act,
                   int(hop_ops.is_bf16(seeds)))
        _SCALARS[key] = scalars
    return scalars


def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    ctrl = _SCRATCH.get(key)
    if ctrl is None:
        ctrl = torch.zeros((SCRATCH_INTS,), dtype=torch.int32, device=device)
        _SCRATCH[key] = ctrl
    return ctrl


def blank_geometry(pred_size, seed_size, deltas, dims):
    """The small reseed blank (hop_engine.py:738-748): its block shape
    min(pred + 2 delta, dims), the offset of its corner from the visited
    minimum, and the widest visited span it covers."""
    pred = np.asarray(pred_size, np.int64)
    seed = np.asarray(seed_size, np.int64)
    off0 = (seed - pred) // 2 - seed // 2
    delta = np.maximum(np.asarray(deltas, np.int64), 1)
    block = np.minimum(pred + 2 * delta, np.asarray(dims, np.int64))
    return (tuple(int(v) for v in block), tuple(int(v) for v in off0),
            tuple(int(v) for v in block - pred))


def _fin_values(fin_opts, seeds):
    """fin_opts as the kernel reads it: the segment threshold and the init
    activation in float32, rounded to bfloat16 for bfloat16 seeds, and the
    minimum size cast to int32 as `astype` truncates."""
    fin_opts = np.asarray(fin_opts, np.float32)
    rnd = hop_ops.bf16_round if hop_ops.is_bf16(seeds) else float
    return (rnd(fin_opts[0]), int(fin_opts[1].astype(np.int32)),
            rnd(fin_opts[2]))


def _verdict_threshold(move_threshold, seeds) -> float:
    """The move threshold of finalize_one's verdict: rounded to bfloat16
    for bfloat16 seeds (`move_t.astype(seed.dtype)`), unlike the dud
    kill's."""
    move_t = np.float32(move_threshold)
    return hop_ops.bf16_round(move_t) if hop_ops.is_bf16(seeds) else \
        float(move_t)


def _at(t, pos):
    return t[tuple(int(v) for v in pos)]


def _clamped(pos, dims):
    """JAX's gather index: each coordinate clamped into the volume."""
    return tuple(min(max(int(v), 0), int(d) - 1) for v, d in zip(pos, dims))


def finalize_pass_plain(state, fstate, blocked, *, fin_opts, move_threshold,
                        max_iters, pred_size, seed_size, deltas):
    dev = state.seeds.device
    seg_t, min_size, init_act = _fin_values(fin_opts, state.seeds)
    move_t = float(np.float32(move_threshold))
    verdict_t = _verdict_threshold(move_threshold, state.seeds)
    dims = tuple(state.seeds.shape[1:])
    block, off0, reach = blank_geometry(pred_size, seed_size, deltas, dims)
    big = float(np.float32(2.0) * np.abs(np.float32(move_t))
                + np.float32(1.0))
    K = fstate.seg.shape[0]
    L = fstate.log.shape[0]

    # The hop loop's cond on the state before this pass (hop_engine.py
    # :1063-1070): dud kill only turns RUNNING lanes into finishers, so the
    # masks after it decide the same.
    running = state.status == hop_ops.RUNNING
    lanes = torch.arange(state.status.shape[0], device=dev)
    s = state.start.long()
    origin = state.seeds[lanes, s[:, 0], s[:, 1], s[:, 2]].float()
    capped = running & (state.iters >= max_iters) if max_iters > 0 else \
        torch.zeros_like(running)
    weak_now = (running & ~capped & ~state.fresh
                & ~(origin >= torch.tensor(move_t, device=dev)))
    state.status.copy_(torch.where(
        capped, hop_ops.DONE_CAP,
        torch.where(weak_now, hop_ops.DONE_WEAK, state.status)))
    st = state.status
    nmask = (((st == hop_ops.DONE_EMPTY) & ~fstate.hold)
             | (st == hop_ops.DONE_WEAK) | (st == hop_ops.DONE_CAP))
    rmask = (st == hop_ops.IDLE) | (st == DONE_FINALIZED)
    fifo_n = int(fstate.fifo_n)
    alive = (bool(running.any()) or bool(nmask.any())
             or (bool(rmask.any()) and int(fstate.fifo_head) < fifo_n))
    nmask, rmask = nmask.tolist(), rmask.tolist()

    while True:
        if True in nmask:
            li = nmask.index(True)
        elif True in rmask and int(fstate.fifo_head) < fifo_n:
            li = rmask.index(True)
        else:
            break
        sv = int(state.sv[li])
        start = state.start[li].tolist()
        status = int(state.status[li])
        iters = int(state.iters[li])
        seed = state.seeds[li]
        seg_sv = fstate.seg[sv]
        blk_sv = blocked[sv]

        do_fin = status in (hop_ops.DONE_EMPTY, hop_ops.DONE_WEAK,
                            hop_ops.DONE_CAP)
        start_ok = bool(_at(seed, start).float() >= verdict_t)
        claimed_at = (bool(_at(seg_sv, start) > 0)
                      or bool(_at(blk_sv, start) & hop_ops.BLOCKED_CLAIMED))
        weak = status == hop_ops.DONE_WEAK or not start_ok
        invalid = iters <= 0
        cand = do_fin and not invalid and not weak and not claimed_at
        sid = int(fstate.next_sid[sv])
        nvox = 0
        if cand:
            mask = ((seed.float() >= seg_t) & (seg_sv == 0)
                    & ((blk_sv & hop_ops.BLOCKED_CLAIMED) == 0))
            nvox = int(mask.sum(dtype=torch.int32))
        ok = cand and nvox >= min_size
        if ok:
            seg_sv[mask] = sid
            fstate.next_sid[sv] += 1
        outcome = (FIN_INVALID if invalid else FIN_SEGMENTED if ok else
                   FIN_WEAK if weak else FIN_CLAIMED if claimed_at else
                   FIN_TOO_SMALL)
        if do_fin:
            row = [sv, sid if ok else 0, *start, iters, nvox, status, outcome,
                   li]
            fstate.log[min(int(fstate.log_n), L - 1)] = torch.tensor(
                row, dtype=torch.int32, device=dev)
            fstate.log_n += 1

        # Pop the FIFO until a seed the segmentation and the claimed bit
        # leave free, or exhaustion.
        head0 = h = int(fstate.fifo_head)
        got, pos2, sv2 = False, start, sv
        while h < fifo_n and not got:
            cand_pos = fstate.fifo_pos[h].tolist()
            csv = int(fstate.fifo_sv[h])
            k = min(max(csv, 0), K - 1)
            at = _clamped(cand_pos, dims)
            got = (int(fstate.seg[k][at]) == 0 and not
                   int(blocked[k][at]) & hop_ops.BLOCKED_CLAIMED)
            h += 1
            if got:
                pos2, sv2 = cand_pos, csv
        skipped = fstate.fifo_sv[head0:h - int(got)].long()
        skipped = skipped[(skipped >= 0) & (skipped < K)]
        fstate.claimed.index_add_(0, skipped, torch.ones_like(
            skipped, dtype=torch.int32))
        fstate.fifo_head.fill_(h)

        if got:
            span = (state.maxp[li] - state.minp[li]).tolist()
            if all(sp <= r for sp, r in zip(span, reach)):
                corner = hop_ops.dynamic_starts(
                    state.minp[li] + torch.tensor(off0, device=dev),
                    torch.tensor(dims, device=dev),
                    torch.tensor(block, device=dev)).tolist()
                seed[tuple(slice(c, c + b) for c, b in zip(corner, block))] \
                    = float("nan")
            else:
                seed.fill_(float("nan"))
            if all(0 <= v < d for v, d in zip(pos2, dims)):
                seed[tuple(pos2)] = init_act
            state.done[li] = 0
            p2 = torch.tensor(pos2, dtype=torch.int32, device=dev)
            state.qpos[li, 0] = p2
            state.qscore[li, 0] = big
            state.sv[li] = sv2
            state.head[li] = 0
            state.tail[li] = 1
            state.start[li] = p2
            state.minp[li] = p2
            state.maxp[li] = p2
        state.iters[li] = 0
        state.status[li] = hop_ops.RUNNING if got else DONE_FINALIZED
        state.fresh[li] = got
        nmask[li] = rmask[li] = False
    return torch.tensor([int(alive)], dtype=torch.int32, device=dev)


def finalize_pass(state, fstate, blocked: torch.Tensor, *, fin_opts,
                  move_threshold: float, max_iters: int,
                  pred_size: Sequence[int], seed_size: Sequence[int],
                  deltas: Sequence[int]) -> torch.Tensor:
    """K8: one finalize pass over every lane, in place.

    state is a LaneState (seeds (B,Z,Y,X) f32 or bf16, the (B,) and (B,3)
    int32 fields, qpos (B,Q,3), qscore (B,Q), done (B,G0,G1,G2) u8, fresh
    (B,) bool) and fstate a FinalizeState (seg (K,Z,Y,X) int32, next_sid (K,),
    fifo_pos (S,3), fifo_sv (S,), the 0-d fifo_n, fifo_head and log_n,
    log (L,10), hold (B,) bool, claimed (K,)), all int32 but where stated;
    blocked (K,Z,Y,X) uint8. fin_opts is float32 [segment_threshold,
    min_segment_size, init_activation] in logit space. Returns (1,) int32:
    1 if the hop loop's cond held on the state before this pass (a lane
    RUNNING, finishable, or idle with FIFO entries left), else 0.
    """
    seeds = state.seeds
    ints = (state.sv, state.qpos, state.head, state.tail, state.start,
            state.minp, state.maxp, state.iters, state.status, fstate.seg,
            fstate.next_sid, fstate.fifo_pos, fstate.fifo_sv, fstate.fifo_n,
            fstate.fifo_head, fstate.log, fstate.log_n, fstate.claimed)
    hop_ops._check_dtypes(NAME, torch.int32, *ints)
    hop_ops._check_dtypes(NAME, torch.float32, state.qscore)
    hop_ops.check_seeds(NAME, seeds)
    hop_ops._check_dtypes(NAME, torch.uint8, state.done, blocked)
    hop_ops._check_dtypes(NAME, torch.bool, state.fresh, fstate.hold)
    if (fstate.seg.shape != blocked.shape
            or tuple(fstate.seg.shape[1:]) != tuple(seeds.shape[1:])
            or fstate.log.shape[1] != LOG_COLUMNS):
        raise ValueError(f"{NAME}: seg {tuple(fstate.seg.shape)}, blocked "
                         f"{tuple(blocked.shape)}, seeds "
                         f"{tuple(seeds.shape)}, log "
                         f"{tuple(fstate.log.shape)}")
    kw = dict(fin_opts=fin_opts, move_threshold=move_threshold,
              max_iters=max_iters, pred_size=pred_size, seed_size=seed_size,
              deltas=deltas)
    if hop_ops._device_of(NAME, seeds) == "cpu":
        return finalize_pass_plain(state, fstate, blocked, **kw)
    B = seeds.shape[0]
    if B > MAX_LANES:
        raise ValueError(f"{NAME}: {B} lanes; the kernel takes at most "
                         f"{MAX_LANES}")
    hop_ops._check_cuda(NAME, seeds, blocked, state.done, state.fresh,
                        state.qscore, fstate.hold, *ints)
    scalars = _kernel_scalars(state, fstate, fin_opts, move_threshold,
                              max_iters, pred_size, seed_size, deltas)
    stream = hop_ops._stream(seeds)
    ctrl = _scratch(seeds.device, stream)
    alive = torch.empty((1,), dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        err = _build.lib().ffn_finalize_pass(
            seeds.data_ptr(), state.sv.data_ptr(), state.qpos.data_ptr(),
            state.qscore.data_ptr(), state.head.data_ptr(),
            state.tail.data_ptr(), state.done.data_ptr(),
            state.start.data_ptr(), state.minp.data_ptr(),
            state.maxp.data_ptr(), state.iters.data_ptr(),
            state.status.data_ptr(), state.fresh.data_ptr(),
            fstate.seg.data_ptr(), fstate.next_sid.data_ptr(),
            fstate.fifo_pos.data_ptr(), fstate.fifo_sv.data_ptr(),
            fstate.fifo_n.data_ptr(), fstate.fifo_head.data_ptr(),
            fstate.log.data_ptr(), fstate.log_n.data_ptr(),
            fstate.hold.data_ptr(), fstate.claimed.data_ptr(),
            blocked.data_ptr(), alive.data_ptr(), ctrl.data_ptr(), *scalars,
            stream)
    _build.check(err, NAME)
    _build.launches[hop_ops.launch_name(NAME, seeds)] += 1
    return alive
