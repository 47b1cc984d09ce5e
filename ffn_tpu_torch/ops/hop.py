"""K4 `hop_pop`, K5 `hop_gather` and K6 `hop_update`: one hop of the
batched flood fill.

The non-model parts of one hop of `HopEngine._run_hops_impl`
(ffn_tpu/inference/hop_engine.py:535):

  K4 hop_pop     lane_pre + pop_one (:553-622, :879-918), the exec-first
                 lane order and n_exec (:947-950);
  K5 hop_gather  lane_patches (:923-933) with the NaN -> pad of
                 `_apply_model` (engine.py:92-94); the screening gather
                 (:1148-1154);
  K6 hop_update  `_apply_model`'s crop and disco mask (engine.py:100-119),
                 lane_exec (:976-1010) with `_face_scores` (engine.py:
                 177-209) and the pushes (:1020-1033); its screen mode
                 `hop_screen` (own launch count) the screening readout
                 (:1156).

CUDA tensors launch `csrc/hop.cu`; CPU tensors run the plain versions, the
kernels' oracles. Lane state is updated in place where JAX donates.

With bfloat16 seeds (FFN_TPU_SEED_DTYPE=bf16) both copy where the JAX
program rounds: K4 compares a stored seed with the unrounded float32 move
threshold (hop_engine.py:572, :890); K5 pads NaN with the pad value rounded
to bfloat16 (engine.py:93; screening keeps its float32 patch, :1148); K6's
disco mask compares the stored seed with the float32 logits (engine.py:
118), the write-back rounds (:983), face maxima and scores come from the
rounded patch (:998-999). Launches count as "<name>_bf16". Starts follow
`lax.dynamic_slice` (wrap once, then clamp); dedup cells clamp into the
grid, as JAX's gather (a hop never makes one out of range).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ffn_tpu_torch import _build

# Lane status codes (device <-> host contract, hop_engine.py:50-57).
IDLE = 0
RUNNING = 1
DONE_EMPTY = 2
DONE_WEAK = 3
DONE_CAP = 4
STALLED_FULL = 5

# Bits of the `blocked` volume (hop_engine.py:69-70).
BLOCKED_CLAIMED = 1
BLOCKED_RESTRICTED = 2

POP = "hop_pop"
GATHER = "hop_gather"
UPDATE = "hop_update"
SCREEN = "hop_screen"

# K4 runs one lane per thread of a single CTA.
MAX_LANES = 1024

# The lane seed dtypes K4-K7 take.
SEED_DTYPES = (torch.float32, torch.bfloat16)


def _i32(values, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in values], dtype=torch.int32,
                        device=device)


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(value)), dtype=torch.float32,
                        device=device)


def bf16_round(value) -> float:
    """A float32 value rounded to bfloat16 (to nearest even), as a float:
    `jnp.float32(value).astype(jnp.bfloat16)`."""
    return float(torch.tensor(float(np.float32(value))).to(
        torch.bfloat16).float())


def is_bf16(seeds: Optional[torch.Tensor]) -> bool:
    return seeds is not None and seeds.dtype == torch.bfloat16


def launch_name(name: str, seeds: Optional[torch.Tensor]) -> str:
    """The launch counter of kernel `name` on these seeds: bfloat16
    launches count apart, under name + "_bf16"."""
    return name + "_bf16" if is_bf16(seeds) else name


def check_seeds(name, seeds: Optional[torch.Tensor]):
    if seeds is not None and seeds.dtype not in SEED_DTYPES:
        raise TypeError(f"{name}: seeds must be float32 or bfloat16, got "
                        f"{seeds.dtype}")


def dynamic_starts(corner: torch.Tensor, dims: torch.Tensor,
                   size: torch.Tensor) -> torch.Tensor:
    """lax.dynamic_slice's start for each row of `corner` (a negative start
    wraps once, then clamps into [0, dims - size])."""
    corner = torch.where(corner < 0, corner + dims, corner)
    return torch.minimum(torch.clamp(corner, min=0), dims - size)


def box_index(rows: torch.Tensor, starts: torch.Tensor,
              size: Sequence[int]):
    """Advanced index of n boxes of `size`: row rows[i], corner starts[i]
    (in bounds) of a (B, Z, Y, X) tensor."""
    ar = [torch.arange(int(n), device=rows.device) for n in size]
    starts = starts.long()
    return (rows.long()[:, None, None, None],
            (starts[:, 0, None] + ar[0])[:, :, None, None],
            (starts[:, 1, None] + ar[1])[:, None, :, None],
            (starts[:, 2, None] + ar[2])[:, None, None, :])


def grid_cells(pos, start, deltas, grid_offset, grid_shape):
    """Dedup-grid cell of each position (hop_engine.py:550), clamped."""
    dev = pos.device
    d = torch.clamp(_i32(deltas, dev), min=1)
    cell = torch.div(pos - start + d // 2, d, rounding_mode="floor") \
        + _i32(grid_offset, dev)
    return torch.minimum(torch.clamp(cell, min=0),
                         _i32(grid_shape, dev) - 1).long()


def _check_cuda(name, *tensors):
    for t in tensors:
        if t is None:
            continue
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _check_dtypes(name, dtype, *tensors):
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device_of(name, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


# -- K4 ----------------------------------------------------------------------


def hop_pop_plain(blocked, shapes, seeds, sv, qpos, head, tail, done, start,
                  iters, status, fresh, skip_threshold, skip_invalid,
                  skip_restricted, executed, pops, *, move_threshold, margin,
                  deltas, grid_offset, max_iters, seg=None):
    B, Q = qpos.shape[:2]
    dev = seeds.device
    lanes = torch.arange(B, device=dev)
    move_t = _f32(move_threshold, dev)
    margin_t = _i32(margin, dev)
    vol = _i32(seeds.shape[1:], dev)
    lane_shape = shapes[sv.long()]

    st = status.clone()
    running = st == RUNNING
    if max_iters > 0:
        capped = running & (iters >= max_iters)
        st = torch.where(capped, DONE_CAP, st)
        running = running & ~capped
    s = start.long()
    origin = seeds[lanes, s[:, 0], s[:, 1], s[:, 2]].float()
    weak = running & ~fresh & ~(origin >= move_t)   # NaN counts as weak
    st = torch.where(weak, DONE_WEAK, st)
    running = running & ~weak
    full = running & (tail - head > Q - 6)
    st = torch.where(full, STALLED_FULL, st)
    running = running & ~full

    # The whole live range of each queue in one window (as wide as the
    # longest queue): the same first valid entry and the same counts as
    # JAX's 16-wide windowed drain.
    width = max(1, int((tail - head).max())) if B else 1
    k = torch.arange(width, device=dev, dtype=torch.int32)
    idx = head[:, None] + k
    in_q = idx < tail[:, None]
    cand = qpos[lanes[:, None], (idx % Q).long()]            # (B, Q, 3)
    in_bounds = ((cand - margin_t >= 0)
                 & (cand + margin_t < lane_shape[:, None])).all(-1)
    safe = torch.minimum(torch.clamp(cand, min=0), vol - 1).long()
    svl = sv.long()[:, None]
    code = blocked[svl, safe[..., 0], safe[..., 1], safe[..., 2]]
    is_blocked = (code & BLOCKED_CLAIMED) > 0
    if seg is not None:   # device-finalize claims (hop_engine.py:566-567)
        is_blocked |= seg[svl, safe[..., 0], safe[..., 1], safe[..., 2]] > 0
    is_restricted = (code & BLOCKED_RESTRICTED) > 0
    cell = grid_cells(cand, start[:, None], deltas, grid_offset,
                      done.shape[1:])
    is_done = done[lanes[:, None], cell[..., 0], cell[..., 1],
                   cell[..., 2]] > 0
    weak_c = ~(seeds[lanes[:, None], safe[..., 0], safe[..., 1],
                     safe[..., 2]].float() >= move_t)
    ok = ((fresh[:, None] | (in_bounds & ~is_blocked & ~is_restricted
                             & ~is_done & ~weak_c))
          & in_q & running[:, None])
    found = ok.any(1)
    first = ok.to(torch.int32).argmax(1)                     # first True
    n_bad = torch.where(found, first, in_q.sum(1, dtype=torch.int32))
    n_bad = torch.where(running, n_bad, 0).to(torch.int32)

    # Counter attribution (hop_engine.py:602-612): dedup discards are
    # uncounted; bounds/claimed -> invalid; restrictor -> restricted;
    # below threshold -> threshold.
    counted = (k[None] < n_bad[:, None]) & in_q & ~is_done
    bad = ~in_bounds | is_blocked
    skip_threshold += (counted & ~bad & ~is_restricted & weak_c).sum(
        1, dtype=torch.int32)
    skip_invalid += (counted & bad).sum(1, dtype=torch.int32)
    skip_restricted += (counted & ~bad & is_restricted).sum(
        1, dtype=torch.int32)

    pos = torch.where(found[:, None], cand[lanes, first.long()], start)
    n_pop = n_bad + found.to(torch.int32)
    head += n_pop
    pops += n_pop
    st = torch.where(running & ~found, DONE_EMPTY, st)
    status.copy_(st)
    pos = torch.minimum(torch.maximum(pos, margin_t),
                        lane_shape - 1 - margin_t).contiguous()
    executed += found.to(torch.int32)
    order = torch.argsort((~found).to(torch.int32), stable=True).to(
        torch.int32)
    summary = torch.stack([found.sum(), (st == RUNNING).sum()]).to(
        torch.int32)
    return pos, found, order, summary


def hop_pop(blocked: torch.Tensor, shapes: torch.Tensor, seeds: torch.Tensor,
            sv: torch.Tensor, qpos: torch.Tensor, head: torch.Tensor,
            tail: torch.Tensor, done: torch.Tensor, start: torch.Tensor,
            iters: torch.Tensor, status: torch.Tensor, fresh: torch.Tensor,
            skip_threshold: torch.Tensor, skip_invalid: torch.Tensor,
            skip_restricted: torch.Tensor, executed: torch.Tensor,
            pops: torch.Tensor, *, move_threshold: float,
            margin: Sequence[int], deltas: Sequence[int],
            grid_offset: Sequence[int], max_iters: int,
            seg: Optional[torch.Tensor] = None):
    """K4: per lane, the iteration cap, weak-origin and queue-full checks,
    then the FIFO drain to the first valid candidate.

    blocked (K,Z,Y,X) uint8 and shapes (K,3) int32 are per subvolume slot;
    seg (K,Z,Y,X) int32, in device-finalize mode, is a second claim source:
    a candidate on a voxel with seg > 0 counts as claimed;
    seeds (B,Z,Y,X) f32 or bf16, qpos (B,Q,3) i32, done (B,G0,G1,G2) u8,
    fresh (B,) bool and the (B,) / (B,3) int32 lane fields are the
    LaneState. Updates head, status and the three skip counters in place
    and adds this hop's execute and pop counts to `executed` and `pops`.
    Returns (pos (B,3) int32 clipped FOV centers, execute (B,) bool, order
    (B,) int32 lane indices executing-first = argsort(~execute, stable),
    summary (2,) int32 [n_exec, lanes still RUNNING]).
    """
    B = seeds.shape[0]
    ints = (sv, qpos, head, tail, start, iters, status, skip_threshold,
            skip_invalid, skip_restricted, executed, pops, shapes)
    _check_dtypes(POP, torch.int32, *ints)
    _check_dtypes(POP, torch.uint8, blocked, done)
    check_seeds(POP, seeds)
    _check_dtypes(POP, torch.bool, fresh)
    _check_dtypes(POP, torch.int32, seg)
    if seg is not None and seg.shape != blocked.shape:
        raise ValueError(f"{POP}: seg {tuple(seg.shape)} for blocked "
                         f"{tuple(blocked.shape)}")
    if _device_of(POP, seeds) == "cpu":
        return hop_pop_plain(
            blocked, shapes, seeds, sv, qpos, head, tail, done, start, iters,
            status, fresh, skip_threshold, skip_invalid, skip_restricted,
            executed, pops, move_threshold=move_threshold, margin=margin,
            deltas=deltas, grid_offset=grid_offset, max_iters=max_iters,
            seg=seg)
    if B > MAX_LANES:
        raise ValueError(f"{POP}: {B} lanes; the kernel takes at most "
                         f"{MAX_LANES}")
    _check_cuda(POP, seeds, blocked, done, fresh, seg, *ints)
    dev = seeds.device
    pos = torch.empty((B, 3), dtype=torch.int32, device=dev)
    execute = torch.empty((B,), dtype=torch.bool, device=dev)
    order = torch.empty((B,), dtype=torch.int32, device=dev)
    summary = torch.empty((2,), dtype=torch.int32, device=dev)
    err = _build.lib().ffn_hop_pop(
        blocked.data_ptr(), _ptr(seg), shapes.data_ptr(), seeds.data_ptr(),
        sv.data_ptr(), qpos.data_ptr(), head.data_ptr(), tail.data_ptr(),
        done.data_ptr(), start.data_ptr(), iters.data_ptr(),
        status.data_ptr(), fresh.data_ptr(), skip_threshold.data_ptr(),
        skip_invalid.data_ptr(), skip_restricted.data_ptr(),
        executed.data_ptr(), pops.data_ptr(), pos.data_ptr(),
        execute.data_ptr(), order.data_ptr(), summary.data_ptr(),
        B, qpos.shape[1], *seeds.shape[1:], *done.shape[1:],
        *(int(v) for v in margin), *(int(v) for v in deltas),
        *(int(v) for v in grid_offset), int(max_iters),
        float(move_threshold), int(is_bf16(seeds)), _stream(seeds))
    _build.check(err, POP)
    _build.launches[launch_name(POP, seeds)] += 1
    return pos, execute, order, summary


# -- K5 ----------------------------------------------------------------------


def hop_gather_plain(image, pos, sv, lanes, seeds, *, image_size, seed_size,
                     pad, init_activation=0.0):
    dev = image.device
    rows = torch.arange(len(pos), device=dev, dtype=torch.int32) \
        if lanes is None else lanes
    p = pos[rows.long()]
    vol = _i32(image.shape[1:], dev)
    isz, ssz = _i32(image_size, dev), _i32(seed_size, dev)
    k = sv[rows.long()]
    k = dynamic_starts(k, _i32([image.shape[0]], dev)[0], 1)
    img = image[box_index(k, dynamic_starts(p - isz // 2, vol, isz),
                          image_size)]
    pad_t = _f32(pad, dev)
    if seeds is None:
        # Screening: every candidate starts from the same fresh patch, NaN
        # but for init_activation at its center (hop_engine.py:1148-1149).
        seed_in = torch.full((len(p),) + tuple(seed_size), float(pad_t),
                             dtype=torch.float32, device=dev)
        seed_in[(slice(None),) + tuple(s // 2 for s in seed_size)] = \
            float(np.float32(init_activation))
    else:
        sp = seeds[box_index(rows, dynamic_starts(p - ssz // 2, vol, ssz),
                             seed_size)].float()
        if is_bf16(seeds):
            pad_t = _f32(bf16_round(pad), dev)
        seed_in = torch.where(torch.isnan(sp), pad_t, sp)
    return img.contiguous(), seed_in.contiguous()


def hop_gather(image: torch.Tensor, pos: torch.Tensor, sv: torch.Tensor,
               lanes: Optional[torch.Tensor], seeds: Optional[torch.Tensor],
               *, image_size: Sequence[int], seed_size: Sequence[int],
               pad: float, init_activation: float = 0.0):
    """K5: the model inputs of S lanes, (S,*image_size) and (S,*seed_size).

    Slot s takes lane lanes[s] (s itself when `lanes` is None): the image
    patch around pos[lane] from image[sv[lane]] ((K,Z,Y,X)) and the seed
    patch from seeds[lane] ((B,Z,Y,X), f32 or bf16) with NaN -> pad (pad
    rounded to bf16 for bf16 seeds). With seeds None (screening) every
    slot's seed patch is the fresh one: pad, and init_activation at the
    center. The outputs are float32.
    """
    _check_dtypes(GATHER, torch.float32, image)
    check_seeds(GATHER, seeds)
    _check_dtypes(GATHER, torch.int32, pos, sv, lanes)
    if _device_of(GATHER, image) == "cpu":
        return hop_gather_plain(image, pos, sv, lanes, seeds,
                                image_size=image_size, seed_size=seed_size,
                                pad=pad, init_activation=init_activation)
    _check_cuda(GATHER, image, pos, sv, lanes, seeds)
    S = len(pos) if lanes is None else len(lanes)
    img = torch.empty((S,) + tuple(image_size), dtype=torch.float32,
                      device=image.device)
    seed_in = torch.empty((S,) + tuple(seed_size), dtype=torch.float32,
                          device=image.device)
    if S == 0:
        return img, seed_in
    err = _build.lib().ffn_hop_gather(
        image.data_ptr(), _ptr(seeds), sv.data_ptr(), pos.data_ptr(),
        _ptr(lanes), img.data_ptr(), seed_in.data_ptr(), S, *image.shape,
        *(int(v) for v in image_size), *(int(v) for v in seed_size),
        bf16_round(pad) if is_bf16(seeds) else float(pad),
        float(init_activation), int(is_bf16(seeds)), _stream(image))
    _build.check(err, GATHER)
    _build.launches[launch_name(GATHER, seeds)] += 1
    return img, seed_in


# -- K6 ----------------------------------------------------------------------


def _first_argmax(flat: torch.Tensor) -> torch.Tensor:
    """jnp.argmax along dim 1: the first NaN if any, else the first max."""
    isn = torch.isnan(flat)
    first_nan = isn.to(torch.int32).argmax(1)
    first_max = torch.where(isn, float("-inf"), flat).argmax(1)
    return torch.where(isn.any(1), first_nan, first_max)


def face_scores_plain(patch: torch.Tensor, deltas: Sequence[int]):
    """Face maxima of (n, pz, py, px) pred-size patches (engine.py:177-209).

    Returns (scores (n, 6) f32, offsets (n, 6, 3) int32); faces ordered
    (z-, z+, y-, y+, x-, x+); faces of zero-delta axes score -inf at offset
    0. The argmax takes the first index among equal maxima.
    """
    n = patch.shape[0]
    dev = patch.device
    center = [s // 2 for s in patch.shape[1:]]
    scores, offsets = [], []
    for axis, d in enumerate(int(v) for v in deltas):
        for sign in (-1, 1):
            if d == 0:
                scores.append(torch.full((n,), float("-inf"),
                                         dtype=torch.float32, device=dev))
                offsets.append(torch.zeros((n, 3), dtype=torch.int32,
                                           device=dev))
                continue
            sel = [slice(c - dd, c + dd + 1)
                   for c, dd in zip(center, (int(v) for v in deltas))]
            sel[axis] = center[axis] + sign * d
            face = patch[(slice(None),) + tuple(sel)]
            flat = face.reshape(n, -1)
            idx = _first_argmax(flat)
            scores.append(flat.gather(1, idx[:, None])[:, 0])
            rel = [idx // face.shape[2] - face.shape[1] // 2,
                   idx % face.shape[2] - face.shape[2] // 2]
            rel.insert(axis, torch.full_like(idx, sign * d))
            offsets.append(torch.stack(rel, 1).to(torch.int32))
    return torch.stack(scores, 1), torch.stack(offsets, 1)


def face_order(scores: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """jnp.lexsort((-off2, -off1, -off0, -scores)) per row (hop_engine.py
    :1001), from stable sorts: torch has no lexsort."""
    order = torch.arange(scores.shape[1], device=scores.device).expand(
        scores.shape).contiguous()
    for key in (-offsets[..., 2], -offsets[..., 1], -offsets[..., 0],
                -scores):
        _, perm = torch.sort(key.gather(1, order), dim=1, stable=True)
        order = order.gather(1, perm)
    return order


def sorted_pushes(scores, offsets, move_threshold):
    """Face moves in push order: (scores, offsets, keep), sorted by
    (-score, -off0, -off1, -off2), with adjacent duplicates dropped."""
    keep = scores >= _f32(move_threshold, scores.device)
    order = face_order(scores, offsets)
    scores = scores.gather(1, order)
    offsets = offsets.gather(1, order[..., None].expand(offsets.shape))
    keep = keep.gather(1, order)
    dup = torch.zeros_like(keep)
    dup[:, 1:] = ((scores[:, 1:] == scores[:, :-1])
                  & (offsets[:, 1:] == offsets[:, :-1]).all(-1))
    return scores, offsets, keep & ~dup


def _disco(crop, old, move_threshold, disco_threshold):
    """_apply_model's disco-seed mask (engine.py:110-119) on (n, *pred)."""
    dev = crop.device
    count = (crop >= _f32(move_threshold, dev)).sum((1, 2, 3))
    # jnp.mean of a 0/1 f32 vector: an exact count over one f32 division.
    frac = count.to(torch.float32) / torch.tensor(
        float(crop[0].numel()), dtype=torch.float32, device=dev)
    disco = _f32(disco_threshold, dev)
    apply = (disco >= 0) & (frac > disco)
    keep_old = apply[:, None, None, None] & (old < 0) & (crop > old)
    return torch.where(keep_old, old, crop)


def hop_update_plain(logits, seeds, pos, execute, lanes, start, done, minp,
                     maxp, iters, fresh, qpos, qscore, head, tail, overflow,
                     *, pred_size, deltas, grid_offset, move_threshold,
                     disco_threshold):
    dev = seeds.device
    Q = qpos.shape[1]
    seed_size = logits.shape[1:]
    sel = execute[lanes.long()]
    rows = lanes.long()[sel]
    logits = logits[sel]
    n = len(rows)
    patch = torch.empty((len(lanes),) + tuple(pred_size),
                        dtype=torch.float32, device=dev)
    if n == 0:
        return patch
    vol = _i32(seeds.shape[1:], dev)
    ssz, psz = _i32(seed_size, dev), _i32(pred_size, dev)
    delta = (ssz - psz) // 2
    p = pos[rows]
    seed_start = p - ssz // 2
    # `old` for the disco mask is the crop of the clamped seed patch
    # (engine.py:105); the write start is clamped on its own (:979-985).
    old_start = dynamic_starts(seed_start, vol, ssz) + delta
    write_start = dynamic_starts(seed_start + delta, vol, psz)
    d = [int(v) for v in delta.tolist()]
    crop = logits[:, d[0]:d[0] + pred_size[0], d[1]:d[1] + pred_size[1],
                  d[2]:d[2] + pred_size[2]]
    old = seeds[box_index(rows, old_start, pred_size)].float()
    new = _disco(crop, old, move_threshold, disco_threshold)
    if is_bf16(seeds):   # the write-back's rounding, before the face maxima
        new = new.to(torch.bfloat16).float()
    patch[sel] = new
    seeds[box_index(rows, write_start, pred_size)] = new.to(seeds.dtype)

    cell = grid_cells(p, start[rows], deltas, grid_offset, done.shape[1:])
    done[rows, cell[:, 0], cell[:, 1], cell[:, 2]] = 1
    minp[rows] = torch.minimum(minp[rows], p)
    maxp[rows] = torch.maximum(maxp[rows], p)
    iters[rows] += 1
    fresh[rows] = False

    scores, offsets, keep = sorted_pushes(
        *face_scores_plain(new, deltas), move_threshold)
    t, h, ov = tail[rows], head[rows], overflow[rows]
    for k in range(scores.shape[1]):
        full = t - h >= Q
        do = keep[:, k] & ~full
        slot = (t % Q).long()
        qpos[rows, slot] = torch.where(do[:, None], p + offsets[:, k],
                                       qpos[rows, slot])
        qscore[rows, slot] = torch.where(do, scores[:, k], qscore[rows, slot])
        t = t + do.to(torch.int32)
        ov = ov + (keep[:, k] & full).to(torch.int32)
    tail[rows] = t
    overflow[rows] = ov
    return patch


def hop_update(logits: torch.Tensor, seeds: torch.Tensor, pos: torch.Tensor,
               execute: torch.Tensor, lanes: torch.Tensor,
               start: torch.Tensor, done: torch.Tensor, minp: torch.Tensor,
               maxp: torch.Tensor, iters: torch.Tensor, fresh: torch.Tensor,
               qpos: torch.Tensor, qscore: torch.Tensor, head: torch.Tensor,
               tail: torch.Tensor, overflow: torch.Tensor, *,
               pred_size: Sequence[int], deltas: Sequence[int],
               grid_offset: Sequence[int], move_threshold: float,
               disco_threshold: float) -> torch.Tensor:
    """K6: the model output of slot s -> lane lanes[s]'s seed and movement
    state, for every slot whose lane executes (the others stay untouched).

    logits (S, *seed_size) is the model output at the seed patches K5
    gathered. Per executing lane: the disco mask over the pred crop, the
    write-back into seeds[lane], its dedup cell, minp/maxp/iters, fresh
    cleared, and the face maxima pushed onto its ring buffer in
    (-score, -off0, -off1, -off2) order without adjacent duplicates. With
    bf16 seeds the written patch is rounded to bf16 (nearest even) and the
    face maxima are taken on it. Returns the written patches (S, *pred_size)
    as float32; rows of idle slots are undefined.
    """
    ints = (pos, lanes, start, minp, maxp, iters, qpos, head, tail, overflow)
    _check_dtypes(UPDATE, torch.int32, *ints)
    _check_dtypes(UPDATE, torch.float32, logits, qscore)
    check_seeds(UPDATE, seeds)
    _check_dtypes(UPDATE, torch.uint8, done)
    _check_dtypes(UPDATE, torch.bool, execute, fresh)
    if logits.shape[0] != lanes.shape[0]:
        raise ValueError(f"{UPDATE}: {logits.shape[0]} logits for "
                         f"{lanes.shape[0]} lanes")
    if _device_of(UPDATE, seeds) == "cpu":
        return hop_update_plain(
            logits, seeds, pos, execute, lanes, start, done, minp, maxp,
            iters, fresh, qpos, qscore, head, tail, overflow,
            pred_size=pred_size, deltas=deltas, grid_offset=grid_offset,
            move_threshold=move_threshold, disco_threshold=disco_threshold)
    _check_cuda(UPDATE, logits, seeds, done, execute, fresh, qscore, *ints)
    n = lanes.shape[0]
    patch = torch.empty((n,) + tuple(pred_size), dtype=torch.float32,
                        device=seeds.device)
    if n == 0:
        return patch
    err = _build.lib().ffn_hop_update(
        logits.data_ptr(), seeds.data_ptr(), pos.data_ptr(),
        execute.data_ptr(), lanes.data_ptr(), start.data_ptr(),
        done.data_ptr(), minp.data_ptr(), maxp.data_ptr(), iters.data_ptr(),
        fresh.data_ptr(), qpos.data_ptr(), qscore.data_ptr(),
        head.data_ptr(), tail.data_ptr(), overflow.data_ptr(),
        patch.data_ptr(), n, qpos.shape[1], *seeds.shape[1:],
        *logits.shape[1:], *(int(v) for v in pred_size), *done.shape[1:],
        *(int(v) for v in deltas), *(int(v) for v in grid_offset),
        float(move_threshold), float(disco_threshold), int(is_bf16(seeds)),
        _stream(seeds))
    _build.check(err, UPDATE)
    _build.launches[launch_name(UPDATE, seeds)] += 1
    return patch


def hop_screen_plain(logits, *, pred_size, move_threshold, disco_threshold,
                     init_activation):
    dev = logits.device
    seed_size = logits.shape[1:]
    d = [(s - p) // 2 for s, p in zip(seed_size, pred_size)]
    crop = logits[:, d[0]:d[0] + pred_size[0], d[1]:d[1] + pred_size[1],
                  d[2]:d[2] + pred_size[2]]
    # The fresh patch is NaN but for init_activation at the seed center.
    c = tuple(p // 2 for p in pred_size)
    at_center = all(dd + cc == s // 2 for dd, cc, s in zip(d, c, seed_size))
    old = torch.full((1,) + tuple(pred_size), float("nan"),
                     dtype=torch.float32, device=dev)
    if at_center:
        old[(0,) + c] = float(np.float32(init_activation))
    new = _disco(crop, old.expand(crop.shape), move_threshold,
                 disco_threshold)
    return new[(slice(None),) + c] >= _f32(move_threshold, dev)


def hop_screen(logits: torch.Tensor, *, pred_size: Sequence[int],
               move_threshold: float, disco_threshold: float,
               init_activation: float) -> torch.Tensor:
    """K6's screen mode: whether each candidate's origin stays at or above
    the move threshold after its first update (hop_engine.py:1151-1156).

    logits (S, *seed_size) is the model output at fresh seed patches.
    Returns (S,) bool; writes nothing else.
    """
    _check_dtypes(SCREEN, torch.float32, logits)
    if _device_of(SCREEN, logits) == "cpu":
        return hop_screen_plain(logits, pred_size=pred_size,
                                move_threshold=move_threshold,
                                disco_threshold=disco_threshold,
                                init_activation=init_activation)
    _check_cuda(SCREEN, logits)
    strong = torch.empty((logits.shape[0],), dtype=torch.bool,
                         device=logits.device)
    if logits.shape[0] == 0:
        return strong
    err = _build.lib().ffn_hop_screen(
        logits.data_ptr(), strong.data_ptr(), logits.shape[0],
        *logits.shape[1:], *(int(v) for v in pred_size),
        float(move_threshold), float(disco_threshold),
        float(init_activation), _stream(logits))
    _build.check(err, SCREEN)
    _build.launches[SCREEN] += 1
    return strong
