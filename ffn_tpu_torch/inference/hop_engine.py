"""Device-resident movement policy: multi-hop flood fill.

Counterpart of ffn_tpu/inference/hop_engine.py in host-finalize mode. Per
lane the device holds a FIFO ring buffer of scored candidate positions, a
visited-cell dedup grid and the seed (POM) buffer; a shared `blocked`
volume carries the claimed and restricted bits. `run_hops` executes up to H
pop -> FFN -> score -> push hops per call, and the host sees one small
per-lane status array per round.

One hop is

  K4 hop_pop (caps, weak origins, stalls, the FIFO drain; exec-first order)
  -> K5 hop_gather (the conv bucket's image and seed patches)
  -> model.apply (the conv stack: K1 for every layer)
  -> K6 hop_update (disco mask, write-back, dedup cell, face maxima, push)

with K7 (ops/lane.py) for the finalize reads, and plain torch tensor ops
for the data movement with no arithmetic (reseed, blocked-region OR, lane
compaction, queue and dedup-grid transfers), as the JAX package's XLA
programs are fills, box copies and row gathers there.

Deviation from the JAX program: JAX runs the hops of a round in one
`lax.while_loop` on the device. Here a Python loop runs them, and each hop
makes ONE small device->host read, of K4's (n_exec, lanes still RUNNING),
at the point where JAX evaluates its loop `cond`. The read picks the conv
bucket (the smallest of B/8, B/4, B/2, B that covers the executing lanes,
hop_engine.py:948-974) and ends the round early when no lane is RUNNING
(:1052-1071). A hop with no executing lane leaves the state as JAX's does:
its conv and K6 have nothing to write. After the loop the packed per-lane
aux array crosses to the host in one copy (:1081-1095). Lane state is
updated in place where the JAX program donates its buffers.

Not ported yet (ROADMAP.md, Queue 2): device finalization (`fstate`,
`fin_opts`, FinalizeState), `run_hops(sync=False)`, `screen_seeds_async`,
and seed buffers in a dtype other than float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ffn_tpu_torch.inference.engine import FloodFillEngine
from ffn_tpu_torch.ops import hop as hop_ops
from ffn_tpu_torch.ops import lane as lane_ops

# Lane status codes (device <-> host contract).
IDLE = hop_ops.IDLE
RUNNING = hop_ops.RUNNING
DONE_EMPTY = hop_ops.DONE_EMPTY      # movement queue exhausted
DONE_WEAK = hop_ops.DONE_WEAK        # origin seed fell below the threshold
DONE_CAP = hop_ops.DONE_CAP          # hit max_iters_per_segment
STALLED_FULL = hop_ops.STALLED_FULL  # queue too full for a move's pushes
DONE_FINALIZED = 6  # device-finalize mode (not ported)

# Device-finalize outcome codes (FinalizeState log rows; not ported).
FIN_SEGMENTED = 1
FIN_WEAK = 2
FIN_TOO_SMALL = 3
FIN_CLAIMED = 4
FIN_INVALID = 5

# Bit codes of the `blocked` volume (uint8).
BLOCKED_CLAIMED = hop_ops.BLOCKED_CLAIMED        # segmentation > 0
BLOCKED_RESTRICTED = hop_ops.BLOCKED_RESTRICTED  # movement restrictor

_ROADMAP = "ffn_tpu_torch ports the host-finalize hop path only (ROADMAP.md, " \
           "Queue 2)"


@dataclasses.dataclass
class LaneState:
    """Device-resident per-lane flood-fill state.

    Positions are in the frame of the lane's subvolume slot `sv` of the
    (K, Z, Y, X) image and blocked stacks given to run_hops (K = 1 for a
    single subvolume)."""
    seeds: torch.Tensor        # (B, Z, Y, X) f32 POM logits, NaN = unvisited
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


class HopEngine(FloodFillEngine):
    """FloodFillEngine plus the device-resident movement programs."""

    SCREEN_BATCH = 256
    SCREEN_BATCH_SMALL = 64

    def __init__(self, model, *, pad_value: float, move_threshold: float,
                 disco_seed_threshold: float, queue_capacity: int = 32768,
                 device="cuda", seed_dtype=torch.float32):
        if seed_dtype != torch.float32:
            raise NotImplementedError(
                f"seed dtype {seed_dtype} (FFN_TPU_SEED_DTYPE=bf16): "
                f"ffn_tpu_torch keeps lane seeds in float32 only (ROADMAP.md, "
                f"Queue 2)")
        super().__init__(model, pad_value=pad_value,
                         move_threshold=move_threshold,
                         disco_seed_threshold=disco_seed_threshold,
                         device=device)
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
                             dtype=torch.float32, device=dev),
            sv=z(B), qpos=z(B, Q, 3), qscore=z(B, Q, dtype=torch.float32),
            head=z(B), tail=z(B), done=z(B, *grid, dtype=torch.uint8),
            start=z(B, 3), minp=z(B, 3), maxp=z(B, 3), iters=z(B),
            status=z(B), fresh=z(B, dtype=torch.bool), overflow=z(B),
            skip_threshold=z(B), skip_invalid=z(B), skip_restricted=z(B))

    def put_blocked(self, blocked: np.ndarray) -> torch.Tensor:
        """Uploads the claimed/restricted uint8 volume (1 = excluded)."""
        return torch.as_tensor(np.ascontiguousarray(blocked, np.uint8),
                               device=self.device).clone()

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
        subvolume slot; None keeps each lane's binding."""
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
                 fstate=None, fin_opts=None):
        """Executes up to `hops` FFN moves per running lane on the device.

        image/blocked are (Z, Y, X) volumes or (K, Z, Y, X) stacks (lanes
        bind to slots via state.sv). `shapes` gives each slot's actual
        (z, y, x) extent for the bounds check; it defaults to the full stack
        shape. Returns (state, aux): the same state object, updated in
        place, and a dict of small host arrays: status, iters, minp, maxp,
        queue_len, overflow, the three skip counters, executed, pops, sv and
        start.
        """
        if fstate is not None or fin_opts is not None:
            raise NotImplementedError(
                f"run_hops with fstate/fin_opts (device finalization): "
                f"{_ROADMAP}")
        if not sync:
            raise NotImplementedError(f"run_hops(sync=False): {_ROADMAP}")
        if image.dim() == 3:
            image = image[None]
            blocked = blocked[None]
        if shapes is None:
            shapes = np.tile(np.array(state.seeds.shape[1:], np.int32),
                             (image.shape[0], 1))
        shapes = torch.as_tensor(np.asarray(shapes, np.int32),
                                 device=self.device)
        B = state.status.shape[0]
        _, grid_off = self.grid_geometry(state.seeds.shape[1:])
        buckets = self._buckets(B)
        executed = torch.zeros((B,), dtype=torch.int32, device=self.device)
        pops = torch.zeros_like(executed)
        s = state
        for _ in range(int(hops)):
            pos, execute, order, summary = hop_ops.hop_pop(
                blocked, shapes, s.seeds, s.sv, s.qpos, s.head, s.tail,
                s.done, s.start, s.iters, s.status, s.fresh,
                s.skip_threshold, s.skip_invalid, s.skip_restricted,
                executed, pops, move_threshold=self._move_threshold,
                margin=self._margin, deltas=self._deltas,
                grid_offset=grid_off, max_iters=int(max_iters))
            # The hop's one device->host read (see the module docstring).
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
            if not n_running:
                break
        packed = torch.cat([
            s.status[:, None], s.iters[:, None], s.minp, s.maxp,
            (s.tail - s.head)[:, None], s.overflow[:, None],
            s.skip_threshold[:, None], s.skip_invalid[:, None],
            s.skip_restricted[:, None], executed[:, None], pops[:, None],
            s.sv[:, None], s.start], dim=1)
        return state, self.unpack_aux(packed.cpu().numpy())

    @staticmethod
    def unpack_aux(packed) -> dict:
        """run_hops' packed per-lane aux as host arrays (int32 end to end:
        cumulative counters through f32 would lose exactness above 2^24)."""
        packed = np.asarray(packed)
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

    # -- screening, verdicts, compaction -------------------------------------

    @torch.no_grad()
    def screen_seeds(self, image: torch.Tensor, positions: np.ndarray,
                     init_activation: float,
                     sv: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched dud-seed screening: the FIRST FFN update of each
        candidate seed (fresh patch, init activation at the center); True
        where the origin stays at or above the move threshold, the check
        that would kill the lane as DONE_WEAK on its second pop
        (hop_engine.py:1119-1207). Candidates run in conv batches of 256,
        padded to 64 or 256 by repeating the last (K1 computes each sample
        on its own, so the padding changes no result).

        image: (Z, Y, X) volume or (K, Z, Y, X) stack; sv gives each
        candidate's slot (default 0). Returns (N,) bool.
        """
        if image.dim() == 3:
            image = image[None]
        positions = np.asarray(positions, np.int32).reshape(-1, 3)
        N = len(positions)
        sv = np.zeros(N, np.int32) if sv is None else np.asarray(sv,
                                                                 np.int32)
        out = np.zeros(N, bool)
        for i in range(0, N, self.SCREEN_BATCH):
            pos, slot = positions[i:i + self.SCREEN_BATCH], sv[
                i:i + self.SCREEN_BATCH]
            n = len(pos)
            batch = self.SCREEN_BATCH if n > self.SCREEN_BATCH_SMALL \
                else self.SCREEN_BATCH_SMALL
            pos = np.concatenate([pos, np.tile(pos[-1:], (batch - n, 1))])
            slot = np.concatenate([slot, np.tile(slot[-1:], batch - n)])
            img_p, seed_in = hop_ops.hop_gather(
                image, torch.as_tensor(pos, device=self.device),
                torch.as_tensor(slot, device=self.device), None, None,
                image_size=self._image_size, seed_size=self._seed_size,
                pad=self._pad_value, init_activation=init_activation)
            logits = self.model.apply(img_p[..., None],
                                      seed_in[..., None])[..., 0]
            strong = hop_ops.hop_screen(
                logits.contiguous(), pred_size=self._pred_size,
                move_threshold=self._move_threshold,
                disco_threshold=self._disco_threshold,
                init_activation=init_activation)
            out[i:i + n] = strong.cpu().numpy()[:n]
        return out

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
