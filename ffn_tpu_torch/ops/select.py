"""K13 `select_gather` and K14 `select_update`: one round of the round-based
batched flood fill.

The non-model parts of `FloodFillEngine._select_step_impl` and its packed
jit (ffn_tpu/inference/engine.py:211-293, :387-403): K13, per lane, the
start's and K candidates' seed values against the move threshold, the
first valid pick and its image and seed patches (NaN -> pad); K14, the
crop and disco mask of `_apply_model` (:100-119), the masked write-back,
the face maxima (`_face_scores`, :177-209) and the packed (B, 30) row.
`_step_batch_impl` (:138-175) is the same round with K = 1 and `ignore`
set. CUDA tensors launch `csrc/select.cu`, CPU tensors the plain versions
(the oracles); seeds update in place. Seed reads follow jnp's traced
indexing, patch starts `lax.dynamic_slice` (wrap once, then clamp).

With bfloat16 seeds both copy the JAX program: K13 compares stored values
with the unrounded float32 move threshold (engine.py:241, :249) and pads
NaN with the pad rounded to bfloat16 (:93); K14's disco mask compares the
stored seed with float32 logits (:118), the write-back rounds (:271), face
maxima come from the rounded patch (:274), the returned masked crops stay
unrounded (:170-173). Launches count as "<name>_bf16".
"""

from __future__ import annotations

from typing import Sequence

import torch

from ffn_tpu_torch import _build
from ffn_tpu_torch.ops.hop import (_check_cuda, _check_dtypes, _device_of,
                                   _disco, _f32, _i32, _stream, bf16_round,
                                   box_index, check_seeds, dynamic_starts,
                                   face_scores_plain, hop_gather_plain,
                                   is_bf16, launch_name)

GATHER = "select_gather"
UPDATE = "select_update"

# Columns of K14's packed row: executed, chosen, start_ok, 6 scores, 18
# offsets, pos (engine.py:285-292).
PACKED_COLUMNS = 30


def unpack_select_input(packed_in: torch.Tensor):
    """(candidates (B,K,3), start (B,3), active (B,) bool, ignore (B,) bool)
    of the (B, 3K+5) int32 upload (engine.py:390-396)."""
    B = packed_in.shape[0]
    K = (packed_in.shape[1] - 5) // 3
    return (packed_in[:, :3 * K].reshape(B, K, 3),
            packed_in[:, 3 * K:3 * K + 3], packed_in[:, 3 * K + 3] > 0,
            packed_in[:, 3 * K + 4] > 0)


def select_gather_plain(image, seeds, packed_in, *, image_size, seed_size,
                        move_threshold, pad):
    dev = seeds.device
    B = seeds.shape[0]
    cands, start, active, ignore = unpack_select_input(packed_in)
    rows = torch.arange(B, device=dev)
    vol = _i32(seeds.shape[1:], dev)
    move_t = _f32(move_threshold, dev)

    def values(pos):   # (B, n, 3) -> (B, n) seed values
        idx = dynamic_starts(pos, vol, 1).long()
        return seeds[rows[:, None], idx[..., 0], idx[..., 1],
                     idx[..., 2]].float()

    start_ok = (values(start[:, None])[:, 0] >= move_t) | ignore
    ok = values(cands) >= move_t
    ok[:, 0] |= ignore
    any_ok = ok.any(1)
    chosen = torch.where(any_ok, ok.to(torch.int32).argmax(1), -1)
    executed = active & start_ok & any_ok
    pos = cands[rows, torch.clamp(chosen, min=0).long()].contiguous()
    img, seed_in = hop_gather_plain(
        image[None], pos, torch.zeros(B, dtype=torch.int32, device=dev), None,
        seeds, image_size=image_size, seed_size=seed_size, pad=pad)
    rec = torch.cat([torch.stack([executed.to(torch.int32),
                                  chosen.to(torch.int32),
                                  start_ok.to(torch.int32)], 1), pos], 1)
    return img, seed_in, rec.to(torch.int32).contiguous()


def select_gather(image: torch.Tensor, seeds: torch.Tensor,
                  packed_in: torch.Tensor, *, image_size: Sequence[int],
                  seed_size: Sequence[int], move_threshold: float,
                  pad: float):
    """K13: each lane's pick among its K candidates and the model inputs at
    it.

    image (Z,Y,X) f32; seeds (B,Z,Y,X) f32 or bf16; packed_in (B, 3K+5)
    int32 holds per lane K candidate positions, the segment start, active
    and ignore. Returns (image patches (B,*image_size), float32 seed patches
    (B,*seed_size) with NaN -> pad (rounded to bf16 for bf16 seeds), record
    (B, 6) int32 [executed, chosen (-1 if none), start_ok, pos z, y, x]).
    """
    _check_dtypes(GATHER, torch.float32, image)
    check_seeds(GATHER, seeds)
    _check_dtypes(GATHER, torch.int32, packed_in)
    B = seeds.shape[0]
    if (packed_in.dim() != 2 or packed_in.shape[0] != B
            or packed_in.shape[1] < 8 or (packed_in.shape[1] - 5) % 3):
        raise ValueError(f"{GATHER}: packed input {tuple(packed_in.shape)} "
                         f"for {B} lanes; want (B, 3K+5), K >= 1")
    if image.shape != seeds.shape[1:]:
        raise ValueError(f"{GATHER}: image {tuple(image.shape)} for seeds "
                         f"{tuple(seeds.shape)}")
    if _device_of(GATHER, seeds) == "cpu":
        return select_gather_plain(image, seeds, packed_in,
                                   image_size=image_size,
                                   seed_size=seed_size,
                                   move_threshold=move_threshold, pad=pad)
    _check_cuda(GATHER, seeds, image, packed_in)
    dev = seeds.device
    img = torch.empty((B,) + tuple(image_size), dtype=torch.float32,
                      device=dev)
    seed_in = torch.empty((B,) + tuple(seed_size), dtype=torch.float32,
                          device=dev)
    rec = torch.empty((B, 6), dtype=torch.int32, device=dev)
    if B == 0:
        return img, seed_in, rec
    err = _build.lib().ffn_select_gather(
        image.data_ptr(), seeds.data_ptr(), packed_in.data_ptr(),
        img.data_ptr(), seed_in.data_ptr(), rec.data_ptr(), B,
        (packed_in.shape[1] - 5) // 3, *seeds.shape[1:],
        *(int(v) for v in image_size), *(int(v) for v in seed_size),
        float(move_threshold),
        bf16_round(pad) if is_bf16(seeds) else float(pad),
        int(is_bf16(seeds)), _stream(seeds))
    _build.check(err, GATHER)
    _build.launches[launch_name(GATHER, seeds)] += 1
    return img, seed_in, rec


def select_update_plain(logits, seeds, rec, *, pred_size, deltas,
                        move_threshold, disco_threshold):
    dev = seeds.device
    B = seeds.shape[0]
    rows = torch.arange(B, device=dev)
    executed = rec[:, 0] > 0
    pos = rec[:, 3:6]
    vol = _i32(seeds.shape[1:], dev)
    seed_size = logits.shape[1:]
    ssz, psz = _i32(seed_size, dev), _i32(pred_size, dev)
    delta = (ssz - psz) // 2
    seed_start = pos - ssz // 2
    # `old` for the disco mask is the crop of the clamped seed patch
    # (engine.py:105); the write start is clamped on its own (:268-273).
    old_start = dynamic_starts(seed_start, vol, ssz) + delta
    write_start = dynamic_starts(seed_start + delta, vol, psz)
    d = [int(v) for v in delta.tolist()]
    crop = logits[:, d[0]:d[0] + pred_size[0], d[1]:d[1] + pred_size[1],
                  d[2]:d[2] + pred_size[2]]
    old = seeds[box_index(rows, old_start, pred_size)].float()
    masked = _disco(crop, old, move_threshold, disco_threshold)
    box = box_index(rows, write_start, pred_size)
    # The write-back's rounding, before the face maxima.
    patch = torch.where(executed[:, None, None, None],
                        masked.to(seeds.dtype), seeds[box]).float()
    seeds[box] = patch.to(seeds.dtype)
    scores, offsets = face_scores_plain(patch, deltas)
    scores = torch.where(executed[:, None], scores,
                         torch.tensor(float("-inf"), device=dev))
    packed = torch.cat([rec[:, :3].to(torch.float32), scores,
                        offsets.reshape(B, 18).to(torch.float32),
                        pos.to(torch.float32)], 1)
    return packed.contiguous(), masked.contiguous()


def select_update(logits: torch.Tensor, seeds: torch.Tensor,
                  rec: torch.Tensor, *, pred_size: Sequence[int],
                  deltas: Sequence[int], move_threshold: float,
                  disco_threshold: float):
    """K14: lane b's model output -> its seed buffer and its packed row.

    logits (B, *seed_size) is the model output at the patches K13 gathered;
    rec (B, 6) int32 is K13's record. Per lane: the disco-masked crop, its
    write-back where the lane executed (rounded to bf16 for bf16 seeds), the
    face maxima of the written patch (scores -inf where it did not). Returns
    (packed (B, 30) f32, the unrounded masked crops (B, *pred_size) f32);
    `seeds` is updated in place.
    """
    _check_dtypes(UPDATE, torch.float32, logits)
    check_seeds(UPDATE, seeds)
    _check_dtypes(UPDATE, torch.int32, rec)
    B = seeds.shape[0]
    if logits.shape[0] != B or rec.shape != (B, 6):
        raise ValueError(f"{UPDATE}: logits {tuple(logits.shape)}, record "
                         f"{tuple(rec.shape)} for {B} lanes")
    if _device_of(UPDATE, seeds) == "cpu":
        return select_update_plain(logits, seeds, rec, pred_size=pred_size,
                                   deltas=deltas,
                                   move_threshold=move_threshold,
                                   disco_threshold=disco_threshold)
    _check_cuda(UPDATE, seeds, logits, rec)
    dev = seeds.device
    packed = torch.empty((B, PACKED_COLUMNS), dtype=torch.float32,
                         device=dev)
    masked = torch.empty((B,) + tuple(pred_size), dtype=torch.float32,
                         device=dev)
    if B == 0:
        return packed, masked
    err = _build.lib().ffn_select_update(
        logits.data_ptr(), seeds.data_ptr(), rec.data_ptr(),
        masked.data_ptr(), packed.data_ptr(), B, *seeds.shape[1:],
        *logits.shape[1:], *(int(v) for v in pred_size),
        *(int(v) for v in deltas), float(move_threshold),
        float(disco_threshold), int(is_bf16(seeds)), _stream(seeds))
    _build.check(err, UPDATE)
    _build.launches[launch_name(UPDATE, seeds)] += 1
    return packed, masked
