"""Device-resident movement policy: multi-hop flood fill.

Counterpart of ffn_tpu/inference/hop_engine.py, in both finalize modes.
Per lane the device holds a FIFO of scored candidates, a visited-cell
dedup grid and the seed (POM) buffer; a shared `blocked` volume carries
the claimed and restricted bits. `run_hops` executes up to H hops a call:

  [K8 finalize_pass] -> K4 hop_pop -> K5 hop_gather -> model.apply (K1 or
  K15) -> K6 hop_update -> [K8 finalize_pass]

with K7 (ops/lane.py) for host finalization's reads and torch ops for
data movement without arithmetic (reseeds, region ORs, slot-stack
updates, FIFO loads, queue transfers), as the JAX programs' fills and box
copies. In device-finalize mode (`fstate`) K8 writes claims into
`fstate.seg` at once and reseeds freed lanes from a FIFO the host loads
each round; the host reads one packed array a round (unpack_round).

Deviations: JAX runs a round's hops in one `lax.while_loop`; here a Python
loop does, with ONE small device->host read a hop after K4 (n_exec and the
running lanes; in device-finalize mode K8's view of the loop's cond),
which picks the conv bucket (B/8 .. B covering the executing lanes,
hop_engine.py:948-974) and ends the round early (:1052-1071). So
`run_hops(sync=False)` returns the packed result as a device tensor but
the round has already run: seed screening cannot queue behind an
in-flight round (PERF.md: t_seed against t_hops). Lane state is updated
in place where JAX donates. Seeds are float32 or bfloat16 (`seed_dtype`);
ops/hop.py and ops/finalize.py say where bfloat16 rounds.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ffn_tpu_torch.inference.engine import FloodFillEngine
from ffn_tpu_torch.ops import finalize as finalize_ops
from ffn_tpu_torch.ops import hop as hop_ops
from ffn_tpu_torch.ops import lane as lane_ops

# Lane status codes (device <-> host contract).
IDLE = hop_ops.IDLE
RUNNING = hop_ops.RUNNING
DONE_EMPTY = hop_ops.DONE_EMPTY      # movement queue exhausted
DONE_WEAK = hop_ops.DONE_WEAK        # origin seed fell below the threshold
DONE_CAP = hop_ops.DONE_CAP          # hit max_iters_per_segment
STALLED_FULL = hop_ops.STALLED_FULL  # queue too full for a move's pushes
DONE_FINALIZED = finalize_ops.DONE_FINALIZED  # finalized, FIFO empty

# Device-finalize outcome codes (FinalizeState log rows).
FIN_SEGMENTED = finalize_ops.FIN_SEGMENTED
FIN_WEAK = finalize_ops.FIN_WEAK            # origin below the move threshold
FIN_TOO_SMALL = finalize_ops.FIN_TOO_SMALL  # masked count < min_segment_size
FIN_CLAIMED = finalize_ops.FIN_CLAIMED      # seed claimed by another object
FIN_INVALID = finalize_ops.FIN_INVALID      # zero executed moves

# Bit codes of the `blocked` volume (uint8).
BLOCKED_CLAIMED = hop_ops.BLOCKED_CLAIMED        # segmentation > 0
BLOCKED_RESTRICTED = hop_ops.BLOCKED_RESTRICTED  # movement restrictor



@dataclasses.dataclass
class LaneState:
    """Device-resident per-lane flood-fill state.

    Positions are in the frame of the lane's subvolume slot `sv` of the
    (K, Z, Y, X) image and blocked stacks given to run_hops (K = 1 for a
    single subvolume)."""
    seeds: torch.Tensor        # (B, Z, Y, X) f32 or bf16 POM logits, NaN =
    #                            unvisited
    sv: torch.Tensor           # (B,) int32 subvolume slot of each lane
    qpos: torch.Tensor         # (B, Q, 3) int32 candidate positions (zyx)
    qscore: torch.Tensor       # (B, Q) f32 candidate scores
    head: torch.Tensor         # (B,) int32 ring-buffer read cursor
    tail: torch.Tensor         # (B,) int32 ring-buffer write cursor
    done: torch.Tensor         # (B, G, G, G) uint8 visited-cell dedup grid
    start: torch.Tensor        # (B, 3) int32 segment origin
    minp: torch.Tensor         # (B, 3) int32 visited bbox low
    maxp: torch.Tensor         # (B, 3) int32 visited bbox high
    iters: torch.Tensor        # (B,) int32 executed FFN moves
    status: torch.Tensor       # (B,) int32 lane status code
    fresh: torch.Tensor        # (B,) bool: next pop bypasses all checks
    overflow: torch.Tensor     # (B,) int32 dropped pushes (ring full)
    skip_threshold: torch.Tensor   # (B,) int32 pops discarded: weak seed
    skip_invalid: torch.Tensor     # (B,) int32 pops discarded: bounds/claimed
    skip_restricted: torch.Tensor  # (B,) int32 pops discarded: restrictor

    def fields(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class FinalizeState:
    """Device-resident finalization state (device-finalize mode,
    hop_engine.py:102-132). fifo_n, fifo_head and log_n are 0-d tensors."""
    seg: torch.Tensor        # (K, Z, Y, X) int32 segmentation (claims)
    next_sid: torch.Tensor   # (K,) int32 next segment id per slot
    fifo_pos: torch.Tensor   # (S, 3) int32 screened seeds of this round
    fifo_sv: torch.Tensor    # (S,) int32 slot of each FIFO seed
    fifo_n: torch.Tensor     # () int32 valid entries this round
    fifo_head: torch.Tensor  # () int32 consumed entries
    log: torch.Tensor        # (L, 10) int32 finalization rows: [sv, sid (0
    #   unless segmented), z, y, x, iters, voxels, lane status, outcome, lane]
    log_n: torch.Tensor      # () int32 rows written this round
    hold: torch.Tensor       # (B,) bool: the host holds spilled queue
    #   entries of this lane; the kernel must not finalize it on DONE_EMPTY
    claimed: torch.Tensor    # (K,) int32 FIFO seeds skipped as claimed


class HostCopy:
    """A device tensor's copy into pinned host memory, started on the
    current stream when made; `numpy()` waits for it. The port's form of
    JAX's copy_to_host_async + np.asarray. A CPU tensor is its own copy."""

    def __init__(self, tensor: torch.Tensor):
        self._event = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def host_array(value) -> np.ndarray:
    """A HostCopy, tensor or array as a host numpy array."""
    if isinstance(value, HostCopy):
        return value.numpy()
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


class HopEngine(FloodFillEngine):
    """FloodFillEngine plus the device-resident movement programs."""

    SCREEN_BATCH = 256
    SCREEN_BATCH_SMALL = 64

    def __init__(self, model, *, pad_value: float, move_threshold: float,
                 disco_seed_threshold: float, queue_capacity: int = 32768,
                 device="cuda", seed_dtype=torch.float32):
        super().__init__(model, pad_value=pad_value,
                         move_threshold=move_threshold,
                         disco_seed_threshold=disco_seed_threshold,
                         device=device, seed_dtype=seed_dtype)
        self.queue_capacity = int(queue_capacity)
        # Conv compaction: run the model over the executing lanes' bucket
        # only. K1 computes each sample on its own, so the result is
        # bit-exact with the full batch; FFN_TPU_COMPACT=0 turns it off as
        # in the JAX engine.
        self.conv_compact = os.environ.get("FFN_TPU_COMPACT", "1") != "0"
        self._margin = tuple(s // 2 for s in self._image_size)
        self._deltas = tuple(int(d) for d in self.info.deltas[::-1])

    # -- state setup ---------------------------------------------------------

    def grid_geometry(self, shape_zyx):
        """Dedup-grid size/offset for a volume shape: cells are
        floor((pos - start + delta//2) / delta) + offset, always in [0, G)."""
        deltas = np.maximum(np.array(self._deltas), 1)
        span = np.ceil(np.array(shape_zyx) / deltas).astype(int)
        grid = 2 * span + 3
        offset = span + 1
        return tuple(int(g) for g in grid), tuple(int(o) for o in offset)

    def init_lane_state(self, lanes: int, shape_zyx) -> LaneState:
        grid, _ = self.grid_geometry(shape_zyx)
        B, Q = lanes, self.queue_capacity
        dev = self.device

        def z(*s, dtype=torch.int32):
            return torch.zeros(s, dtype=dtype, device=dev)

        return LaneState(
            seeds=torch.full((B,) + tuple(shape_zyx), float("nan"),
                             dtype=self.seed_dtype, device=dev),
            sv=z(B), qpos=z(B, Q, 3), qscore=z(B, Q, dtype=torch.float32),
            head=z(B), tail=z(B), done=z(B, *grid, dtype=torch.uint8),
            start=z(B, 3), minp=z(B, 3), maxp=z(B, 3), iters=z(B),
            status=z(B), fresh=z(B, dtype=torch.bool), overflow=z(B),
            skip_threshold=z(B), skip_invalid=z(B), skip_restricted=z(B))

    def init_finalize_state(self, K: int, lanes: int, shape_zyx,
                            fifo_capacity: int = 0) -> FinalizeState:
        """Device-finalize state for K subvolume slots (hop_engine.py
        :190-214). The log cannot overflow within a round: every kernel
        finalization consumes a lane that was RUNNING, and lanes enter
        RUNNING by a host reseed (<= B a round) or a kernel reseed (each
        consumes a FIFO entry, <= S a round)."""
        S = int(fifo_capacity) or max(2 * lanes, 256)
        L = S + lanes + 4
        if K > 17:
            # The packed round's header row carries [log_n, fifo_head,
            # claimed[0..K)] in the aux array's 19 columns.
            raise ValueError(f"device-finalize supports <= 17 slots "
                             f"(got {K})")
        dev = self.device

        def z(*s):
            return torch.zeros(s, dtype=torch.int32, device=dev)

        return FinalizeState(
            seg=z(K, *shape_zyx), next_sid=z(K) + 1, fifo_pos=z(S, 3),
            fifo_sv=z(S), fifo_n=z(), fifo_head=z(),
            log=z(L, finalize_ops.LOG_COLUMNS), log_n=z(),
            hold=torch.zeros((lanes,), dtype=torch.bool, device=dev),
            claimed=z(K))

    def _upload(self, array: np.ndarray, out: torch.Tensor):
        """Copies a host array into a device tensor without waiting for the
        device (pinned staging on CUDA), so uploads queue behind work in
        flight as JAX's dispatches do."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        if out.device.type == "cuda":
            src = src.pin_memory()
        out.copy_(src, non_blocking=True)
        return out

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        array = np.ascontiguousarray(array)
        out = torch.empty(array.shape, dtype=torch.from_numpy(array).dtype,
                          device=self.device)
        return self._upload(array, out)

    def round_prep(self, fstate: FinalizeState, pos: np.ndarray,
                   sv: np.ndarray, hold: np.ndarray) -> FinalizeState:
        """Loads this round's screened-seed FIFO, resets the log, the
        cursor and the skip counts, and sets the per-lane hold flags
        (hop_engine.py:216-239), in place."""
        S = fstate.fifo_pos.shape[0]
        n = len(pos)
        if n > S:
            raise ValueError(f"fifo overflow: {n} > {S}")
        pos_p = np.zeros((S, 3), np.int32)
        sv_p = np.zeros((S,), np.int32)
        pos_p[:n] = np.asarray(pos, np.int32).reshape(-1, 3)
        sv_p[:n] = sv
        self._upload(pos_p, fstate.fifo_pos)
        self._upload(sv_p, fstate.fifo_sv)
        fstate.fifo_n.fill_(n)
        fstate.fifo_head.zero_()
        fstate.log_n.zero_()
        self._upload(np.asarray(hold, bool), fstate.hold)
        fstate.claimed.zero_()
        return fstate

    def drain_log(self, fstate: FinalizeState):
        """This round's finalization rows, the FIFO consumption cursor and
        the per-slot count of FIFO seeds skipped as claimed
        (hop_engine.py:241-252): (rows (N, 10) int64, fifo_head int,
        claimed (K,) int64)."""
        n = int(fstate.log_n)
        head = int(fstate.fifo_head)
        claimed = fstate.claimed.cpu().numpy().astype(np.int64)
        return (fstate.log[:n].cpu().numpy().astype(np.int64), head,
                claimed)

    def reset_slot_seg(self, fstate: FinalizeState, slot: int,
                       next_sid: int = 1) -> FinalizeState:
        """Clears one slot's device segmentation and sets the first id the
        kernel assigns there (slot reload; hop_engine.py:254-271)."""
        fstate.seg[int(slot)].zero_()
        fstate.next_sid[int(slot)] = int(next_sid)
        return fstate

    def slice_slot_seg(self, fstate: FinalizeState, slot: int,
                       size_zyx) -> torch.Tensor:
        """A copy of one slot's segmentation cropped to its true size, shape
        (1, *size_zyx) (hop_engine.py:273-280). A copy, because the slot is
        reset in place for its next subvolume while the save still reads
        it."""
        box = tuple(slice(0, int(v)) for v in size_zyx)
        return fstate.seg[(slice(int(slot), int(slot) + 1),) + box].clone()

    def download_slot_seg(self, fstate: FinalizeState, slot: int,
                          size_zyx) -> np.ndarray:
        """One slot's segmentation, cropped to its true size
        (hop_engine.py:282-287)."""
        return self.slice_slot_seg(fstate, slot, size_zyx).cpu().numpy()[0]

    def put_blocked(self, blocked: np.ndarray) -> torch.Tensor:
        """Uploads the claimed/restricted uint8 volume (1 = excluded)."""
        return torch.as_tensor(np.ascontiguousarray(blocked, np.uint8),
                               device=self.device).clone()

    def put_stack(self, arrays, shape_zyx, dtype, fill=0.0) -> torch.Tensor:
        """Uploads a (K, Z, Y, X) stack of subvolumes; entries smaller than
        shape_zyx are padded with `fill`, None entries are all `fill`
        (hop_engine.py:293-303)."""
        stack = np.full((len(arrays),) + tuple(shape_zyx), fill, dtype)
        for k, a in enumerate(arrays):
            if a is not None:
                stack[k][tuple(slice(0, s) for s in a.shape)] = a
        return self._to_device(stack)

    def update_stack_slot(self, stack: torch.Tensor, slot: int, volume,
                          fill=0.0) -> torch.Tensor:
        """Replaces one slot of a (K, Z, Y, X) stack in place, padding the
        volume to the slot shape with `fill` (hop_engine.py:305-330). A
        device tensor of the full slot shape and the stack's dtype is
        copied as it is: drivers pad and upload images ahead, off the round
        loop."""
        shape = tuple(stack.shape[1:])
        if (isinstance(volume, torch.Tensor)
                and tuple(volume.shape) == shape
                and volume.dtype == stack.dtype):
            stack[int(slot)].copy_(volume)
            return stack
        padded = np.full(shape, fill,
                         torch.empty(0, dtype=stack.dtype).numpy().dtype)
        volume = np.asarray(volume)
        padded[tuple(slice(0, s) for s in volume.shape)] = volume
        self._upload(padded, stack[int(slot)])
        return stack

    def update_blocked_region(self, blocked: torch.Tensor, start_zyx,
                              region: np.ndarray,
                              slot: int = 0) -> torch.Tensor:
        """ORs a sub-box into the blocked volume (after a finalization), in
        place. Accepts a (Z, Y, X) volume or a (K, Z, Y, X) stack (`slot`
        selects the subvolume). The box is bucketed like lane_seed_region
        with its start clamped into the volume; the region lands at its true
        offset inside the bucket, so clamping near the upper faces never
        displaces the write (hop_engine.py:332-369)."""
        shape = blocked.shape[-3:]
        bucket, start = self._bucket_start(shape, region.shape, start_zyx)
        off = np.asarray(start_zyx, np.int64) - start
        padded = np.zeros(bucket, np.uint8)
        padded[tuple(slice(int(o), int(o) + s)
                     for o, s in zip(off, region.shape))] = region
        box = tuple(slice(int(s), int(s) + b) for s, b in zip(start, bucket))
        target = blocked[int(slot)] if blocked.dim() == 4 else blocked
        target[box] |= torch.from_numpy(padded).to(blocked.device)
        return blocked

    # -- reseed --------------------------------------------------------------

    def reseed_lanes(self, state: LaneState, reset_mask: np.ndarray,
                     pos: np.ndarray, init_activation: float,
                     sv: Optional[np.ndarray] = None) -> LaneState:
        """Resets the selected lanes to a fresh segment at pos, in place:
        clears the seed buffer and dedup grid, plants the initial
        activation, and queues the origin as the (unconditionally accepted)
        first move (hop_engine.py:373-428). sv rebinds reset lanes to a
        subvolume slot; None keeps each lane's binding. The activation is
        stored in the seed dtype (rounded to nearest even for bfloat16)."""
        dev = self.device
        reset = torch.as_tensor(np.asarray(reset_mask, bool), device=dev)
        lanes = torch.nonzero(reset).squeeze(1)
        if not len(lanes):
            return state
        p = torch.as_tensor(np.asarray(pos, np.int32),
                            device=dev)[lanes]
        s = state
        s.seeds[lanes] = float("nan")
        s.seeds[lanes, p[:, 0].long(), p[:, 1].long(), p[:, 2].long()] = \
            float(np.float32(init_activation))
        s.done[lanes] = 0
        s.qpos[lanes, 0] = p
        # 2 |move_t| + 1 in float32: definitely above the threshold.
        move_t = torch.tensor(self._move_threshold, dtype=torch.float32)
        s.qscore[lanes, 0] = float(2.0 * move_t.abs() + 1.0)
        if sv is not None:
            s.sv[lanes] = torch.as_tensor(np.asarray(sv, np.int32),
                                          device=dev)[lanes]
        s.head[lanes] = 0
        s.tail[lanes] = 1
        s.start[lanes] = p
        s.minp[lanes] = p
        s.maxp[lanes] = p
        s.iters[lanes] = 0
        s.status[lanes] = RUNNING
        s.fresh[lanes] = True
        for counter in (s.overflow, s.skip_threshold, s.skip_invalid,
                        s.skip_restricted):
            counter[lanes] = 0
        return state

    # -- the hop program -----------------------------------------------------

    def _buckets(self, lanes: int):
        if not self.conv_compact:
            return [lanes]
        return sorted({max(1, lanes // 8), max(1, lanes // 4),
                       max(1, lanes // 2), lanes})

    @torch.no_grad()
    def run_hops(self, image: torch.Tensor, blocked: torch.Tensor,
                 state: LaneState, hops: int, max_iters: int = 0,
                 shapes: Optional[np.ndarray] = None, sync: bool = True,
                 fstate: Optional[FinalizeState] = None,
                 fin_opts: Optional[np.ndarray] = None):
        """Executes up to `hops` FFN moves per running lane on the device.

        image/blocked are (Z, Y, X) volumes or (K, Z, Y, X) stacks (lanes bind
        to slots via state.sv); `shapes` gives each slot's (z, y, x) extent for
        the bounds check (default: the stack's). With `fstate` (device-finalize
        mode) K8 finalizes finished lanes (claims into fstate.seg at once) and
        reseeds them from fstate's FIFO mid-round; `fin_opts` is float32
        [segment_threshold, min_segment_size, init_activation]. Returns (state,
        fstate, aux) in that mode, else (state, aux): the states updated in place
        and a dict of small host arrays (status, iters, minp, maxp, queue_len,
        overflow, the skip counters, executed, pops, sv, start); with
        sync=False the packed device tensor instead (unpack_aux, unpack_round)."""
        fin = fstate is not None
        if fin and fin_opts is None:
            raise ValueError("device-finalize mode needs fin_opts")
        if image.dim() == 3:
            image = image[None]
            blocked = blocked[None]
        if shapes is None:
            shapes = np.tile(np.array(state.seeds.shape[1:], np.int32),
                             (image.shape[0], 1))
        shapes = self._to_device(np.asarray(shapes, np.int32))
        B = state.status.shape[0]
        _, grid_off = self.grid_geometry(state.seeds.shape[1:])
        buckets = self._buckets(B)
        executed = torch.zeros((B,), dtype=torch.int32, device=self.device)
        pops = torch.zeros_like(executed)
        fin_kw = dict(fin_opts=fin_opts, move_threshold=self._move_threshold,
                      max_iters=int(max_iters), pred_size=self._pred_size,
                      seed_size=self._seed_size, deltas=self._deltas)
        s = state
        for _ in range(int(hops)):
            if fin:
                # Finalize and reseed at the hop's entry, so refilled lanes
                # execute this hop's conv (hop_engine.py:875-876).
                alive = finalize_ops.finalize_pass(s, fstate, blocked,
                                                   **fin_kw)
            pos, execute, order, summary = hop_ops.hop_pop(
                blocked, shapes, s.seeds, s.sv, s.qpos, s.head, s.tail,
                s.done, s.start, s.iters, s.status, s.fresh,
                s.skip_threshold, s.skip_invalid, s.skip_restricted,
                executed, pops, move_threshold=self._move_threshold,
                margin=self._margin, deltas=self._deltas,
                grid_offset=grid_off, max_iters=int(max_iters),
                seg=fstate.seg if fin else None)
            # The hop's one device->host read (see the module docstring).
            if fin:
                n_exec, n_running, alive = torch.cat(
                    [summary, alive]).tolist()
                if not alive:
                    break
            else:
                n_exec, n_running = summary.tolist()
            if n_exec:
                S = next(b for b in buckets if n_exec <= b)
                img_p, seed_in = hop_ops.hop_gather(
                    image, pos, s.sv, order[:S], s.seeds,
                    image_size=self._image_size, seed_size=self._seed_size,
                    pad=self._pad_value)
                logits = self.model.apply(img_p[..., None],
                                          seed_in[..., None])[..., 0]
                hop_ops.hop_update(
                    logits[:n_exec].contiguous(), s.seeds, pos, execute,
                    order[:n_exec], s.start, s.done, s.minp, s.maxp,
                    s.iters, s.fresh, s.qpos, s.qscore, s.head, s.tail,
                    s.overflow, pred_size=self._pred_size,
                    deltas=self._deltas, grid_offset=grid_off,
                    move_threshold=self._move_threshold,
                    disco_threshold=self._disco_threshold)
            if fin:
                # Same-hop finishers, finalized before the next hop
                # (hop_engine.py:1042-1043).
                finalize_ops.finalize_pass(s, fstate, blocked, **fin_kw)
            elif not n_running:
                break
        packed = torch.cat([
            s.status[:, None], s.iters[:, None], s.minp, s.maxp,
            (s.tail - s.head)[:, None], s.overflow[:, None],
            s.skip_threshold[:, None], s.skip_invalid[:, None],
            s.skip_restricted[:, None], executed[:, None], pops[:, None],
            s.sv[:, None], s.start], dim=1)
        if not fin:
            if not sync:
                return state, packed
            return state, self.unpack_aux(packed.cpu().numpy())
        # One array for the round: aux rows, the header row [log_n,
        # fifo_head, claimed[0..K)], then the log padded to 19 columns
        # (hop_engine.py:1096-1113).
        C = packed.shape[1]
        K = fstate.claimed.shape[0]
        header = torch.cat([fstate.log_n.reshape(1),
                            fstate.fifo_head.reshape(1), fstate.claimed,
                            torch.zeros((C - 2 - K,), dtype=torch.int32,
                                        device=self.device)])
        logp = torch.nn.functional.pad(fstate.log,
                                       (0, C - fstate.log.shape[1]))
        packed = torch.cat([packed, header[None], logp])
        if not sync:
            return state, fstate, packed
        return state, fstate, self.unpack_aux(packed[:B].cpu().numpy())

    @staticmethod
    def unpack_aux(packed) -> dict:
        """run_hops' packed per-lane aux (a HostCopy, tensor or array) as
        host arrays (int32 end to end: cumulative counters through f32
        would lose exactness above 2^24)."""
        packed = host_array(packed)
        aux = {
            "status": packed[:, 0],
            "iters": packed[:, 1],
            "minp": packed[:, 2:5].astype(np.int64),
            "maxp": packed[:, 5:8].astype(np.int64),
            "queue_len": packed[:, 8],
            "overflow": packed[:, 9],
            "skip_threshold": packed[:, 10].astype(np.int64),
            "skip_invalid": packed[:, 11].astype(np.int64),
            "skip_restricted": packed[:, 12].astype(np.int64),
            "executed": packed[:, 13].astype(np.int64),
            "pops": packed[:, 14].astype(np.int64),
        }
        if packed.shape[1] > 15:
            aux["sv"] = packed[:, 15]
        if packed.shape[1] > 16:
            aux["start"] = packed[:, 16:19].astype(np.int64)
        return aux

    @staticmethod
    def unpack_round(packed, lanes: int, slots: int):
        """A device-finalize round's packed result (a HostCopy, tensor or
        array) as (aux, log rows (N, 10) int64, fifo_head, claimed (K,)
        int64) (hop_engine.py:519-533). Layout (int32): rows [0, lanes) the
        per-lane aux, row `lanes` [log_n, fifo_head, claimed[0..slots)],
        then the padded log."""
        packed = host_array(packed)
        aux = HopEngine.unpack_aux(packed[:lanes])
        header = packed[lanes]
        log_n, fifo_head = int(header[0]), int(header[1])
        claimed = header[2:2 + slots].astype(np.int64)
        rows = packed[lanes + 1:lanes + 1 + log_n, :10].astype(np.int64)
        return aux, rows, fifo_head, claimed

    # -- screening, verdicts, compaction -------------------------------------

    def screen_seeds(self, image: torch.Tensor, positions: np.ndarray,
                     init_activation: float,
                     sv: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched dud-seed screening: the FIRST FFN update of each
        candidate seed (fresh patch, init activation at the center); True
        where the origin stays at or above the move threshold, the check
        that would kill the lane as DONE_WEAK on its second pop
        (hop_engine.py:1119-1170), in batches of SCREEN_BATCH.

        image: (Z, Y, X) volume or (K, Z, Y, X) stack; sv gives each
        candidate's slot (default 0). Returns (N,) bool.
        """
        positions = np.asarray(positions, np.int32).reshape(-1, 3)
        N = len(positions)
        sv = np.zeros(N, np.int32) if sv is None else np.asarray(sv,
                                                                 np.int32)
        out = np.zeros(N, bool)
        for i in range(0, N, self.SCREEN_BATCH):
            strong = self.screen_seeds_async(
                image, positions[i:i + self.SCREEN_BATCH], init_activation,
                sv=sv[i:i + self.SCREEN_BATCH])
            n = min(self.SCREEN_BATCH, N - i)
            out[i:i + n] = strong.cpu().numpy()[:n]
        return out

    @torch.no_grad()
    def screen_seeds_async(self, image: torch.Tensor, positions: np.ndarray,
                           init_activation: float,
                           sv: Optional[np.ndarray] = None) -> torch.Tensor:
        """Queues ONE screen batch of 1..SCREEN_BATCH candidates (K5 -> K1
        -> K6's screen mode) and returns the device bool tensor without
        waiting (hop_engine.py:1172-1207). Element i belongs to
        positions[i]; the batch is padded to 64 or 256 by repeating the
        last candidate (K1 computes each sample on its own, so the padding
        changes no result), and the pad tail is to be discarded."""
        if image.dim() == 3:
            image = image[None]
        positions = np.asarray(positions, np.int32).reshape(-1, 3)
        n = len(positions)
        if n > self.SCREEN_BATCH or n == 0:
            raise ValueError(f"screen_seeds_async takes 1..{self.SCREEN_BATCH}"
                             f" candidates, got {n}")
        sv = np.zeros(n, np.int32) if sv is None else np.asarray(sv,
                                                                 np.int32)
        batch = self.SCREEN_BATCH if n > self.SCREEN_BATCH_SMALL \
            else self.SCREEN_BATCH_SMALL
        positions = np.concatenate(
            [positions, np.tile(positions[-1:], (batch - n, 1))])
        sv = np.concatenate([sv, np.tile(sv[-1:], batch - n)])
        img_p, seed_in = hop_ops.hop_gather(
            image, self._to_device(positions), self._to_device(sv), None,
            None, image_size=self._image_size, seed_size=self._seed_size,
            pad=self._pad_value, init_activation=init_activation)
        logits = self.model.apply(img_p[..., None],
                                  seed_in[..., None])[..., 0]
        return hop_ops.hop_screen(
            logits.contiguous(), pred_size=self._pred_size,
            move_threshold=self._move_threshold,
            disco_threshold=self._disco_threshold,
            init_activation=init_activation)

    def lane_verdicts(self, state: LaneState, blocked: torch.Tensor,
                      segment_threshold: float, move_threshold: float):
        """For EVERY lane, through K7: (unclaimed voxels >= segment_threshold
        in its seed buffer, origin >= move_threshold). Finalization uses it
        as a pre-gate that rejects weak and too-small lanes without a
        region download (hop_engine.py:1209-1245).

        Returns (counts (B,) int64, start_ok (B,) bool) as host arrays.
        """
        if blocked.dim() == 3:
            blocked = blocked[None]
        counts, ok = lane_ops.lane_verdicts(
            state.seeds, state.sv, state.start, blocked,
            segment_threshold=segment_threshold,
            move_threshold=move_threshold)
        return (counts.cpu().numpy().astype(np.int64),
                ok.cpu().numpy().astype(bool))

    def compact_lanes(self, state: LaneState, keep) -> Optional[LaneState]:
        """A new LaneState holding only the lanes in `keep` (rows may
        repeat), or None if the copy does not fit in device memory
        (hop_engine.py:1247-1314). The input stays intact either way."""
        keep = torch.as_tensor(np.asarray(keep, np.int64), device=self.device)
        leaves = state.fields()
        out_bytes = sum(t[0].numel() * t.element_size() * len(keep)
                        for t in leaves.values())
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if 1.5 * out_bytes > free:
                return None
        return LaneState(**{name: t.index_select(0, keep)
                            for name, t in leaves.items()})

    # -- checkpoint support --------------------------------------------------

    def download_lane_queue(self, state: LaneState, lane: int):
        """(positions (N, 3), scores (N,)) of the lane's pending FIFO
        entries, oldest first (for checkpointing)."""
        head = int(state.head[lane])
        tail = int(state.tail[lane])
        idx = np.arange(head, tail) % self.queue_capacity
        return (state.qpos[lane].cpu().numpy()[idx],
                state.qscore[lane].cpu().numpy()[idx])

    def upload_lane_queue(self, state: LaneState, lane: int,
                          positions: np.ndarray, scores: np.ndarray,
                          ) -> LaneState:
        """Replaces one lane's queue contents (checkpoint restore)."""
        n = len(positions)
        if n > self.queue_capacity:
            raise ValueError(f"queue overflow on restore: {n}")
        dev = self.device
        state.qpos[lane, :n] = torch.as_tensor(
            np.asarray(positions, np.int32).reshape(-1, 3), device=dev)
        state.qscore[lane, :n] = torch.as_tensor(
            np.asarray(scores, np.float32), device=dev)
        state.head[lane] = 0
        state.tail[lane] = n
        return state

    def download_lane_done(self, state: LaneState, lane: int) -> np.ndarray:
        return state.done[lane].cpu().numpy().copy()

    def upload_lane_done(self, state: LaneState, lane: int,
                         done: np.ndarray) -> LaneState:
        state.done[lane] = torch.as_tensor(np.asarray(done, np.uint8),
                                           device=self.device)
        return state
