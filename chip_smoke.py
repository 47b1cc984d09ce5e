#!/usr/bin/env python3
"""Drives ffn_tpu_torch's inference paths (serial, hop, round-based, fused
multi-subvolume; float32, bfloat16 and int8; bfloat16 lane seeds), its
two trainers, ResConvStack and the device edge mask on one NVIDIA card.

  python3 chip_smoke.py

Phases (a failure ends the run with a non-zero exit; each function says
what it holds):
  1. device: the card's name and power limit, torch/CUDA versions, which
     of protobuf/absl/h5py/jax this machine has;
  2. build: K1-K23 from ffn_tpu_torch/csrc, one nvcc per source;
  3. every kernel against its plain version at the main paths' shapes,
     with CUDA-event times (kernel, plain, library), bounds: K1 per layer
     and as the stack; K2-K8, K13, K14 bit for bit with float32 and bf16
     seeds on crafted states; K9-K12, K16 at batch 4; K15 per layer and
     as the stack against plain and the float64 sums; the 16-bit training
     kernels (K15 in float16, K17, K18 on both bodies, K12's scale); K19
     and K20 (int8)
     bit for bit per layer and as the stack; K10 (B = 4, 1) and K19 (N =
     1, 64) on the device alone beside their library calls;
  4. the fib25 model against the JAX package's stored logits;
  5. the serial slice (Runner -> Canvas) on the padded 100^3 phantom,
     kernels and plain, then model-r2 held to 0.95;
  6. the 64-lane hop slice (HopBatchCanvas -> run_hops); the gate's
     8-lane pair, and on a 64^3 corner also with K4-K7 plain, identical;
  7. the gate pair at 64 lanes with the CI checkpoint against the JAX
     package's run (tests/golden/gate_ci_lanes_golden.npz);
  8. the fused slice (sharded CLI, 8 x 82^3, 4 slots, 64 lanes), device
     and host finalization, each also on one box with K4/K7/K8 plain;
  9-10. the CI checkpoint's and model-r2's fused runs against
     tests/golden/fused_{ci,r2}_golden;
 11. the scan trainer at full width, 8 steps: kernels against plain, an
     exact resume, a profiled step, train_ci_golden, the Runner;
 12. the round-based slice (hops 0) at 8 lanes on kernels, kernels and
     plain on a 64^3 corner; 64 lanes;
 13. the CI checkpoint at 64 lanes, hops 0, against the JAX package's run;
 14. bfloat16 inference on K15 and its plain version: serial, hop, round
     and fused slices;
 15. the host-loop trainer at full width, 40 steps (K16);
 16. bf16 lane seeds on every inference path on the *_bf16 kernels, each
     against its plain versions, identical (hop and round on the whole
     phantom, the others on a 64^3 corner); against float32 seeds;
 17. the train CLI with --precision bf16 and f16 (K15, K17, K18: 648
     tensor-core and 27 CUDA-core K18 launches a step; f16's loss scale in
     K11, K12), against plain, f16 resumed exactly; one steady step of each
     under torch.profiler (device against wall); the host loop in bf16;
 18. int8 inference (FFN_TPU_PRECISION=int8, K19, K20): serial, 64-lane hop
     and fused slices on kernels, each against its plain versions on a
     64^3 corner, identical;
 19. the remaining TPU programs, which no path calls: K21 (LayerNorm) bit
     for bit; ResConvStack (depth 20, 32 features) on K21 + K1/K15
     against its plain layers; edges() on K22/K23 bit for bit at 132^3
     and 250^3.
The line before the last, {"kernels": [...]}, gives each kernel its
launches by path and in sum, its error against plain, its median time,
its plain version's, a library call's where one exists, and its bound.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PHANTOM_SIZE = 100   # cube edge of the phantom (250 in the shipped demo)
PHANTOM_CELLS = 8    # the demo's 120 cells per 250^3, scaled to 100^3
PHANTOM_PAD = 16     # reflect padding = FOV margin: border cells reachable
REPS = 10            # timed runs per kernel and per plain version
LANES = 64           # concurrent_requests of the hop slice (README.md)
HOPS = 16            # FFN_TPU_HOPS' default
MAX_ITERS = 4000     # tools/quality_eval.py's Q_MAX_ITERS
GATE_LANES = 8       # lanes of the batched-vs-serial pair (one per cell)
SCREEN = 256         # HopEngine.SCREEN_BATCH: candidates per screen batch
FUSED_SUB = 82       # fused slice: 2x2x2 subvolumes of 82^3 over 132^3
FUSED_OVERLAP = 32
FUSED_SLOTS = 4      # fewer slots than subvolumes: slots reload
CI_SUB, CI_OVERLAP, CI_LANES, CI_HOPS = 48, 16, 16, 8   # the fused golden
R2_SUB, R2_OVERLAP = 64, 32   # the model-r2 fused reference (96^3)
# Agreement floors just under the values measured on the H100 (whole cells
# of 8): the fused slice at 64 lanes (0.625, 0.875; lanes split cells as
# the JAX package's do) and the round slice at 64 lanes (1.0).
FUSED_AGREE_FLOOR, FUSED_HOST_AGREE_FLOOR = 0.6, 0.85
ROUND_LANES = 8      # concurrent_requests of the round slice (hops 0)
ROUND64_AGREE_FLOOR = 0.99
INIT_ACT = float(np.float32(np.log(0.95 / 0.05)))   # init_activation 0.95
# bfloat16 floors: hop (8 lanes) the quality gate's 0.95, fused under its
# measured 0.625; serial and round 0.95.
BF16_HOP_AGREE_FLOOR = 0.95
BF16_FUSED_AGREE_FLOOR = 0.6
# bf16 lane seeds at the JAX e2e bench's configuration
# (tools/e2e_bench.py:45-50: 48 lanes, hops 16, max_iters 2000, host
# finalization, model-r2 in bfloat16); floor under its measured 1.0.
SEED_LANES, SEED_MAX_ITERS = 48, 2000
BF16_SEED_AGREE_FLOOR = 0.99
# Floors under the bf16-seed fused (0.75) and round (0.875: a split cell,
# on plain versions too; ROADMAP Queue 3) slices' measured agreements.
BF16_SEED_FUSED_AGREE_FLOOR = 0.7
BF16_SEED_ROUND_AGREE_FLOOR = 0.85
# K15's batch sizes; its depth-12 stack within 2^-6 of max|plain logit|.
K15_NS = (1, 8, 64, 256)
K15_STACK_TOL = 2.0 ** -6


# Published H100 SXM peaks (NVIDIA's datasheet): HBM, float32, dense
# 16-bit and int8 tensor cores. A bound is the larger of bytes (each input
# read and output written once) over the first and operations over their
# peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# int8 (K19, K20): model-r2's layer kinds (k, Cin, Cout, relu_in, relu_out,
# residual); the int8 slices' agreement floors, under their measured values
# (H100, 700 W): serial 1.0 (held to the gate's 0.95), hop at 64 lanes
# 0.875 and fused 0.625 (lanes split cells, as in float32 and in the JAX
# package: floors 0.85 and 0.6, float32's fused floor).
Q_LAYERS = {"conv0_a": (3, 2, 32, False, True, False),
            "block_a": (3, 32, 32, True, True, False),
            "block_b": (3, 32, 32, False, False, True),
            "conv_lom": (1, 32, 1, True, False, True)}
INT8_FLOORS = {"serial_int8": 0.95, "hop_int8": 0.85, "fused_int8": 0.6}
# (path, precision) -> (rate, objects, agreement) of the slices that phase
# 18 compares with.
SLICE_RATES = {}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_of(nbytes=0.0, flops=0.0, peak=F32_FLOPS):
    """(bound_ms, bound_by) of a call that moves `nbytes` and does `flops`
    at `peak` operations per second."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def entry(err, ms, plain_ms, nbytes=0.0, flops=0.0, library_ms=None,
          peak=F32_FLOPS):
    """One kernel's numbers for the {"kernels": [...]} line."""
    bound_ms, bound_by = bound_of(nbytes, flops, peak)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def time_many(*fns, reps=REPS, inner=10):
    """Median ms per call of each fn: `reps` samples of each, taken in
    turns, each timing `inner` back-to-back calls by CUDA events (as the
    calls follow each other in a step)."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / inner)
    return tuple(statistics.median(t) for t in times)


def device_alone_ms(*fns, calls=10):
    """Device ms a call of each fn with the host's gaps left out: the sum of
    its kernels' times under torch.profiler, each kernel's mean over the
    events the profiler kept times its launches a call."""
    out = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if us > 0 and ev.count and \
                    ev.device_type == torch.autograd.DeviceType.CUDA:
                total += us / ev.count * max(1, round(ev.count / calls))
        out.append(total / 1e3)
    return tuple(out)


def time_pair(kernel_fn, plain_fn, reps=REPS, inner=10):
    return time_many(kernel_fn, plain_fn, reps=reps, inner=inner)


def time_restored(fns, restore, reps=REPS):
    """Median ms of single calls of each fn (in turns), each from the state
    `restore()` puts back outside the timed region: for kernels that update
    their state in place, call by call."""
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, out in zip(fns, times):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


# Every layer kind of the depth-12 stack: (k, Cin, Cout, pre_relu,
# post_relu, residual).
K1_LAYERS = {
    "2->32 post_relu": (3, 2, 32, False, True, False),
    "32->32 pre+post_relu": (3, 32, 32, True, True, False),
    "32->32 +residual": (3, 32, 32, False, False, True),
    "32->1 k=1 pre_relu +residual": (1, 32, 1, True, False, True),
}


def k1_work(n, k, cin, cout):
    """(bytes, flops) of one SAME conv layer on N 33^3 samples."""
    vox = n * 33 ** 3
    return (4 * (vox * (cin + cout) + k ** 3 * cin * cout + cout),
            2 * vox * k ** 3 * cin * cout)


def check_k1(randn, n, reps):
    """K1 against its plain version (cuDNN) on N 33^3 samples for every layer
    kind, within 1e-4 of max|plain|; with `reps`, timed beside one F.conv3d
    call (no fused relus or residual). Returns [(name, err, ms, plain_ms,
    library_ms)]."""
    from ffn_tpu_torch.ops import conv3d
    out = []
    for name, (k, cin, cout, pre, post, res) in K1_LAYERS.items():
        x = randn(n, 33, 33, 33, cin)
        w = randn(k, k, k, cin, cout, scale=(2.0 / (k ** 3 * cin)) ** 0.5)
        b = randn(cout, scale=0.1)
        r = randn(n, 33, 33, 33, cout) if res else None
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        got = conv3d.conv3d_ndhwc_f32(x, w, b, **kw)
        want = conv3d.conv3d_ndhwc_plain(x, w, b, **kw)
        err = float((got - want).abs().max())
        bound = 1e-4 * float(want.abs().max())
        del got, want
        ms = plain_ms = lib_ms = float("nan")
        if reps:
            xc = x.permute(0, 4, 1, 2, 3).contiguous()
            wc = w.permute(4, 3, 0, 1, 2).contiguous()
            ms, plain_ms, lib_ms = time_many(
                lambda: conv3d.conv3d_ndhwc_f32(x, w, b, **kw),
                lambda: conv3d.conv3d_ndhwc_plain(x, w, b, **kw),
                lambda: torch.nn.functional.conv3d(xc, wc, b,
                                                   padding=k // 2),
                reps=reps)
            del xc, wc
        bound_ms, bound_by = bound_of(*k1_work(n, k, cin, cout))
        print(f"K1 conv3d_ndhwc_f32 N={n} {name}: max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} "
              f"ms library conv3d {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by})")
        require(err <= bound, f"K1 N={n} {name}: error {err} above {bound}")
        out.append((name, err, ms, plain_ms, lib_ms))
    return out


def k15_work(n, k, cin, cout, x_bytes, res_bytes, out_bytes):
    """(bytes, flops) of one bfloat16 SAME conv layer on N 33^3 samples."""
    vox = n * 33 ** 3
    return (vox * (cin * x_bytes + cout * (res_bytes + out_bytes))
            + 2 * (k ** 3 * cin * cout + cout),
            2 * vox * k ** 3 * cin * cout)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ["google.protobuf", "absl", "h5py", "jax"]}
    print(f"host packages: {have}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return have


def phase_build():
    from ffn_tpu_torch import _build
    t0 = time.time()
    path = _build.build()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{os.path.relpath(path, REPO)} in {time.time() - t0:.1f} s")
    _build.lib()


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    gen = torch.Generator().manual_seed(0)
    fov = (33, 33, 33)
    results = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    k1 = check_k1(randn, n=1, reps=REPS)
    # The JSON line carries the 32->32 layer's time: 22 of the 24 layers.
    results["conv3d_ndhwc_f32"] = entry(
        max(e for _, e, *_ in k1), k1[1][2], k1[1][3],
        *k1_work(1, 3, 32, 32), library_ms=k1[1][4])
    vol = (PHANTOM_SIZE + 2 * PHANTOM_PAD,) * 3
    image = randn(*vol)
    seed = randn(*vol, scale=3.0)
    seed[randn(*vol) > 0] = float("nan")
    require(bool(torch.isnan(seed).any()), "K2 input holds no NaN")
    logits = randn(*fov, scale=3.0)
    for seed_dtype in (torch.float32, torch.bfloat16):
        results.update(_step_kernels(seed.to(seed_dtype), image, logits))
    return results


def _step_kernels(seed, image, logits):
    """K2 and K3 against their plain versions, bit for bit, at the serial
    path's shapes on `seed` (float32, or bfloat16 with seeds on the
    rounding edges of a move threshold that rounds down); their times."""
    from ffn_tpu_torch.ops import step as step_ops
    tk = _tests()
    bf16 = seed.dtype == torch.bfloat16
    sfx, nbytes = ("_bf16", 2) if bf16 else ("", 4)
    gen = torch.Generator().manual_seed(2)
    move_t = tk.MOVE_T_LO if bf16 else float(np.float32(np.log(0.9 / 0.1)))
    if bf16:
        edges = torch.from_numpy(tk.bf16_edges(move_t))
        pick = torch.rand(seed.shape, generator=gen) < 0.2
        seed[pick.to(seed.device)] = edges[torch.randint(
            len(edges), (int(pick.sum()),), generator=gen)].to(seed)
    fov, pos, nvox = (33, 33, 33), (40, 57, 83), 33 ** 3
    pad = float(np.float32(np.log(0.05 / 0.95)))
    got = step_ops.step_gather(image, seed, pos, fov, fov, pad)
    want = step_ops.step_gather_plain(image, seed, pos, fov, fov, pad)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K2 step_gather{sfx} differs from plain: {err}")
    ms, plain_ms = time_pair(
        lambda: step_ops.step_gather(image, seed, pos, fov, fov, pad),
        lambda: step_ops.step_gather_plain(image, seed, pos, fov, fov, pad))
    print(f"K2 step_gather{sfx} (33^3 of {tuple(seed.shape)}, NaN seed): "
          f"bit-exact kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    # Reads the image and seed patches, writes both float32 model inputs.
    results = {"step_gather" + sfx: entry(err, ms, plain_ms,
                                          (12 + nbytes) * nvox)}
    frac = float((logits >= move_t).float().mean())
    for disco in (-1.0, 0.0, frac + 0.05):
        kseed, pseed = seed.clone(), seed.clone()
        kpatch = step_ops.step_update(logits, kseed, pos, fov, move_t, disco)
        ppatch = step_ops.step_update_plain(logits, pseed, pos, fov, move_t,
                                            disco)
        require(torch.equal(kpatch, ppatch) and torch.equal(
            torch.nan_to_num(kseed, nan=7.0), torch.nan_to_num(pseed,
                                                               nan=7.0))
                and kseed.dtype == seed.dtype,
                f"K3 step_update{sfx} differs from plain at disco={disco}")
        kept = int((ppatch != logits).sum())
        print(f"K3 step_update{sfx} disco={disco:.4f} (frac {frac:.4f}): "
              f"bit-exact, {kept} voxels kept their old value")
    ms, plain_ms = time_pair(
        lambda: step_ops.step_update(logits, kseed, pos, fov, move_t, 0.0),
        lambda: step_ops.step_update_plain(logits, pseed, pos, fov, move_t,
                                           0.0))
    print(f"K3 step_update{sfx} (33^3): kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms")
    # Reads the logits and the old seed patch, writes the seed patch and
    # the float32 patch.
    results["step_update" + sfx] = entry(0.0, ms, plain_ms,
                                         (8 + 2 * nbytes) * nvox)
    return results


def _tests():
    """tests/test_torch_kernels.py: the crafted states and their helpers."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_kernels
    return test_torch_kernels


def _hop_lane_kernels(dev, seed_dtype):
    """K4-K7 against their plain versions, bit for bit, on a crafted 64-lane
    state at the hop slice's shapes (132^3, queues of 32768, 33^3), seeds in
    `seed_dtype` (bfloat16: seeds on the thresholds' rounding edges, a move
    threshold that rounds down); their times. Returns (results, the state,
    the tests' helpers)."""
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    tk = _tests()

    bf16 = seed_dtype == torch.bfloat16
    sfx, seed_bytes = ("_bf16", 2) if bf16 else ("", 4)
    rng = np.random.RandomState(0)
    vol = (PHANTOM_SIZE + 2 * PHANTOM_PAD,) * 3
    fov, deltas, Q = 33, (8, 8, 8), 32768
    lanes = tk.crafted_lanes(rng, LANES, vol, Q, fov, deltas, MAX_ITERS)
    move_t = tk.MOVE_T_LO if bf16 else tk.MOVE_T   # K7's
    if bf16:
        tk.bf16_seed_edges(rng, lanes["seeds"], tk.MOVE_T)
        tk.bf16_seed_edges(rng, lanes["seeds"], move_t)
    lanes["image"] = rng.randn(1, *vol).astype(np.float32)
    logits = torch.from_numpy(tk.tied_logits(rng, LANES, fov)).to(dev)
    if bf16:   # float32 logits off the bfloat16 grid: the write-back rounds
        logits += torch.from_numpy(rng.randn(LANES, fov, fov, fov).astype(
            np.float32) * 1e-3).to(dev)
    ks, ps = tk.to_torch(lanes, dev), tk.to_torch(lanes, dev)
    ks["seeds"] = ks["seeds"].to(seed_dtype)
    ps["seeds"] = ps["seeds"].to(seed_dtype)
    require(bool(torch.isnan(ks["seeds"]).any()), "K4 input holds no NaN")
    kw = dict(fov=fov, pred=fov, deltas=deltas, max_iters=MAX_ITERS,
              disco=0.0)
    before = {k: v.clone() for k, v in ps.items()}
    for hop in range(3):
        got = tk.hop_step(hop_ops, ks, logits, **kw)
        want = tk.hop_step(tk._PlainHop, ps, logits, **kw)
        torch.cuda.synchronize()
        n_exec = int(want[3][0])
        require(n_exec > 0, "the crafted state executed no lane")
        same = all(torch.equal(g, w) for g, w in zip(got[:6], want[:6]))
        same &= torch.equal(got[6][:n_exec], want[6][:n_exec])
        same &= all(torch.equal(torch.nan_to_num(ks[k].float(), nan=7.0),
                                torch.nan_to_num(ps[k].float(), nan=7.0))
                    for k in ps)
        require(same, f"K4-K6 on {seed_dtype} seeds differ from their plain "
                      f"versions at hop {hop}")
    counts = {name: int(ps[name].max()) for name in (
        "skip_threshold", "skip_invalid", "skip_restricted")}
    statuses = sorted(set(ps["status"].tolist()))
    print(f"K4 hop_pop + K5 hop_gather + K6 hop_update on {seed_dtype} "
          f"seeds, 3 hops of {LANES} lanes on {vol}: bit-exact; max skips "
          f"per lane {counts}; statuses {statuses}; n_exec {n_exec}")
    require(min(counts.values()) > 16 and 5 in statuses and 4 in statuses,
            "the crafted state missed a skip kind, a stall or a cap")

    seg_t = float(np.float32(np.log(0.6 / 0.4)))
    vkw = dict(segment_threshold=seg_t, move_threshold=move_t)
    got = lane_ops.lane_verdicts(ks["seeds"], ks["sv"], ks["start"],
                                 ks["blocked"], **vkw)
    want = lane_ops.lane_verdicts_plain(ks["seeds"], ks["sv"], ks["start"],
                                        ks["blocked"], **vkw)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K7 verdicts on {seed_dtype} seeds differ from plain")
    box = ((10, 40, 70), (64, 64, 62), tuple(lanes["start"][5]))
    mkw = dict(threshold=seg_t, move_threshold=move_t)
    got = lane_ops.lane_mask(ks["seeds"], 5, *box, **mkw)
    want = lane_ops.lane_mask_plain(ks["seeds"], 5, *box, **mkw)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K7 mask on {seed_dtype} seeds differs from plain")
    print(f"K7 lane_threshold on {seed_dtype} seeds: verdicts of {LANES} "
          f"lanes and a 64^3 mask bit-exact ({int(want[0].sum())} voxels "
          f"set)")

    # Times at the slice's shapes. K4 and K6 update lane state in place:
    # K4 is timed from the same state each call (its (B,)-sized fields are
    # restored inside the timed region, for kernel and plain alike).
    state = {k: v.clone() for k, v in before.items()}
    grid_off = tk.grid_geometry(vol, deltas)[1]
    small = ("head", "status", "skip_threshold", "skip_invalid",
             "skip_restricted", "executed", "pops")

    def pop(fn):
        def call():
            for k in small:
                state[k].copy_(before[k])
            return fn(
                state["blocked"], state["shapes"], state["seeds"],
                state["sv"], state["qpos"], state["head"], state["tail"],
                state["done"], state["start"], state["iters"],
                state["status"], state["fresh"], state["skip_threshold"],
                state["skip_invalid"], state["skip_restricted"],
                state["executed"], state["pops"],
                move_threshold=tk.MOVE_T, margin=(fov // 2,) * 3,
                deltas=deltas, grid_offset=grid_off, max_iters=MAX_ITERS)
        return call

    results = {}
    nvox = fov ** 3   # voxels of one 33^3 patch
    pop_ms = time_pair(pop(hop_ops.hop_pop), pop(hop_ops.hop_pop_plain))
    pos, execute, order, summary = pop(hop_ops.hop_pop)()
    n_exec = int(summary[0])
    # K4 reads, per examined queue entry, its position (12 bytes), the
    # blocked code, the seed value and the dedup cell; per lane ~16 int32
    # fields, read and written.
    entries = int((state["pops"] - before["pops"]).sum())
    results["hop_pop" + sfx] = entry(
        0.0, *pop_ms, (14 + seed_bytes) * entries + 64 * LANES)
    gkw = dict(image_size=(fov,) * 3, seed_size=(fov,) * 3, pad=tk.PAD)
    # K5 reads an image and a seed patch and writes two float32 patches.
    results["hop_gather" + sfx] = entry(0.0, *time_pair(
        lambda: hop_ops.hop_gather(state["image"], pos, state["sv"], order,
                                   state["seeds"], **gkw),
        lambda: hop_ops.hop_gather_plain(state["image"], pos, state["sv"],
                                         order, state["seeds"], **gkw)),
        (12 + seed_bytes) * nvox * len(order))

    def update(fn):
        return lambda: fn(
            logits[:n_exec], state["seeds"], pos, execute, order[:n_exec],
            state["start"], state["done"], state["minp"], state["maxp"],
            state["iters"], state["fresh"], state["qpos"], state["qscore"],
            state["head"], state["tail"], state["overflow"],
            pred_size=(fov,) * 3, deltas=deltas, grid_offset=grid_off,
            move_threshold=tk.MOVE_T, disco_threshold=0.0)

    # K6 reads each executing lane's logits and old patch and writes its
    # seed patch and the returned float32 patch.
    results["hop_update" + sfx] = entry(0.0, *time_pair(
        update(hop_ops.hop_update), update(hop_ops.hop_update_plain)),
        (8 + 2 * seed_bytes) * nvox * n_exec)
    results["lane_threshold" + sfx] = entry(0.0, *time_pair(
        lambda: lane_ops.lane_verdicts(ks["seeds"], ks["sv"], ks["start"],
                                       ks["blocked"], **vkw),
        lambda: lane_ops.lane_verdicts_plain(ks["seeds"], ks["sv"],
                                             ks["start"], ks["blocked"],
                                             **vkw)),
        int(np.prod(vol)) * (seed_bytes * LANES + ks["blocked"].shape[0]))
    mask_ms = time_pair(lambda: lane_ops.lane_mask(ks["seeds"], 5, *box,
                                                   **mkw),
                        lambda: lane_ops.lane_mask_plain(ks["seeds"], 5,
                                                         *box, **mkw))
    for name, r in results.items():
        print(f"{name} at {LANES} lanes on {vol}: kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})" + (f" ({n_exec} executing lanes)"
                                      if name.startswith("hop_update")
                                      else ""))
    mask_bound = bound_of((1 + seed_bytes) * int(np.prod(box[1])))[0]
    print(f"lane_threshold{sfx} mask (64^3 box): kernel {mask_ms[0]:.4f} ms "
          f"plain {mask_ms[1]:.4f} ms bound {mask_bound:.5f} ms (bytes)")
    return results, ks, tk, rng


def phase_hop_kernels(dev):
    """K4-K7 on crafted 64-lane states (float32 and bf16 seeds), K6's screen
    mode on 256 candidates, K1 at N = 64, 256 and as the stack, N=1 = N=64."""
    from ffn_tpu_torch.models import convstack_3d, params_io
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import hop as hop_ops

    bf16_results, _, _, _ = _hop_lane_kernels(dev, torch.bfloat16)
    torch.cuda.empty_cache()
    results, ks, tk, rng = _hop_lane_kernels(dev, torch.float32)
    results.update(bf16_results)
    vol = tuple(ks["seeds"].shape[1:])
    fov, deltas = 33, (8, 8, 8)
    patch = 4 * fov ** 3   # bytes of one 33^3 float32 patch

    # K6's screen mode at a screen batch: K5 gathers fresh patches, and
    # hop_screen reads each origin's verdict off tied model outputs.
    spos = torch.from_numpy(rng.randint(0, vol[0], size=(SCREEN, 3)).astype(
        np.int32)).to(dev)
    ssv = torch.zeros(SCREEN, dtype=torch.int32, device=dev)
    skw = dict(image_size=(fov,) * 3, seed_size=(fov,) * 3, pad=tk.PAD,
               init_activation=INIT_ACT)
    got = hop_ops.hop_gather(ks["image"], spos, ssv, None, None, **skw)
    want = hop_ops.hop_gather_plain(ks["image"], spos, ssv, None, None, **skw)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "K5 screen gather differs from plain")
    slogits = torch.from_numpy(tk.tied_logits(rng, SCREEN, fov)).to(dev)
    ckw = dict(pred_size=(fov,) * 3, move_threshold=tk.MOVE_T,
               disco_threshold=0.0, init_activation=INIT_ACT)
    strong = hop_ops.hop_screen(slogits, **ckw)
    require(torch.equal(strong, hop_ops.hop_screen_plain(slogits, **ckw)),
            "hop_screen differs from plain")
    print(f"K5 screen gather + hop_screen, {SCREEN} fresh candidates: "
          f"bit-exact ({int(strong.sum())} strong)")
    # The screen reads each candidate's pred crop (the disco count).
    results["hop_screen"] = entry(0.0, *time_pair(
        lambda: hop_ops.hop_screen(slogits, **ckw),
        lambda: hop_ops.hop_screen_plain(slogits, **ckw)), SCREEN * patch)
    print(f"hop_screen at {SCREEN} candidates: kernel "
          f"{results['hop_screen']['ms']:.4f} ms plain "
          f"{results['hop_screen']['plain_ms']:.4f} ms")
    del slogits, got, want

    # K1 at the hop path's batch sizes, against its plain version: the
    # conv buckets (N=8, 16, 32 and 64, the last timed) and a screen batch
    # (N=256), every layer kind; then the whole depth-12 stack of model-r2
    # on a 64-lane batch, on K1 and with every layer on the plain version.
    cgen = torch.Generator(device=dev).manual_seed(1)

    def crandn(*shape, scale=1.0):
        return torch.randn(*shape, generator=cgen, device=dev) * scale

    k1 = check_k1(crandn, n=LANES, reps=5)
    for n in (LANES // 8, LANES // 4, LANES // 2, SCREEN):
        k1 += check_k1(crandn, n=n, reps=0)
    torch.cuda.empty_cache()
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[fov] * 3, deltas=list(deltas), depth=12)
    model.load_params(params_io.load_params_npz(
        os.path.join(REPO, "models", "phantom", "model-r2.npz")))
    model.to(dev)
    img = crandn(LANES, fov, fov, fov, 1)
    sd = crandn(LANES, fov, fov, fov, 1, scale=3.0)
    batch = model.apply(img, sd)
    with mock.patch.object(convstack_3d, "conv3d_ndhwc_f32",
                           conv3d.conv3d_ndhwc_plain):
        plain = model.apply(img, sd)
    err = float((batch - plain).abs().max())
    bound = 1e-4 * float(plain.abs().max())
    print(f"K1 conv stack (model-r2, depth 12, 33^3) at N={LANES}: "
          f"max_abs_err {err:.3e} against the plain stack (bound "
          f"{bound:.3e})")
    require(bool(torch.isfinite(batch).all()) and err <= bound,
            f"K1 stack at N={LANES}: error {err} above {bound}")
    results["conv3d_ndhwc_f32@hop"] = max([err] + [e for _, e, *_ in k1])

    # K1: one sample at N=1 and inside an N=64 batch, bit for bit.
    for i in (0, 17, LANES - 1):
        one = model.apply(img[i:i + 1].contiguous(), sd[i:i + 1].contiguous())
        require(torch.equal(one[0], batch[i]),
                f"K1: sample {i} at N=1 differs from N={LANES}")
    print(f"K1 conv stack (depth 12, 33^3): samples 0, 17, {LANES - 1} at "
          f"N=1 bit-identical to the same samples at N={LANES}")
    return results


def _k8_state(dev, seed_dtype):
    """K8's crafted state (64 lanes, 4 slots of 82^3, every branch;
    bfloat16: thresholds that round down and two lanes on the origin
    bf16(move_t) < move_t): (the tests' helpers, a factory of lane and
    finalize states, blocked, fin_opts, the pass's keywords, lanes)."""
    tk = _tests()
    rng = np.random.RandomState(1)
    shape = (FUSED_SUB,) * 3
    fov, deltas, Q = 33, (8, 8, 8), 32768
    fifo = max(8 * LANES, 512)   # the fused driver's FIFO
    lanes, fin, blocked, opts = tk.crafted_finalize(
        rng, LANES, FUSED_SLOTS, shape, Q, fifo, fov, deltas, MAX_ITERS,
        1000)
    move_t = tk.MOVE_T
    if seed_dtype == torch.bfloat16:
        move_t = tk.MOVE_T_LO
        tk.bf16_finalize_edges(rng, lanes, fin, opts, move_t)
    blk = torch.from_numpy(blocked).to(dev)

    def state():
        lane_state = tk.to_torch(lanes, dev)
        lane_state["seeds"] = lane_state["seeds"].to(seed_dtype)
        return lane_state, tk.to_torch(fin, dev)
    kw = dict(fov=fov, deltas=deltas, max_iters=MAX_ITERS,
              move_threshold=move_t)
    return tk, state, blk, opts, kw, lanes


def _k8_empty(work):
    """The state of a pass that finalizes nothing (the common case: every
    lane running and fresh), in place."""
    work[0]["status"].fill_(1)
    work[0]["fresh"].fill_(True)
    work[0]["iters"].fill_(1)


def _k8_kernels(dev, seed_dtype):
    """K8 against its plain version, bit for bit, over two passes of
    _k8_state's crafted state, and a pass that finalizes nothing; their
    times through the wrapper (CUDA events) and its host time."""
    from ffn_tpu_torch.ops import finalize as fin_ops
    bf16 = seed_dtype == torch.bfloat16
    sfx, nbytes = ("_bf16", 2) if bf16 else ("", 4)
    shape, fov, deltas = (FUSED_SUB,) * 3, 33, (8, 8, 8)
    tk, state, blk, opts, kw, lanes = _k8_state(dev, seed_dtype)
    ks, ps, snap = state(), state(), state()
    for turn in range(2):
        got = tk.finalize_step(fin_ops.finalize_pass, *ks, blk, opts, **kw)
        want = tk.finalize_step(fin_ops.finalize_pass_plain, *ps, blk, opts,
                                **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and all(
            tk.nan_equal(k[name], p[name])
            for k, p in zip(ks, ps) for name in p)
        require(same and ks[0]["seeds"].dtype == seed_dtype,
                f"K8 finalize_pass{sfx} differs from plain in pass {turn}")
        if turn == 0:
            first = {name: t.clone() for name, t in {**ps[0],
                                                     **ps[1]}.items()}
    log = first["log"][:int(first["log_n"])].cpu().numpy()
    outcomes = sorted(set(log[:, 8].tolist()))
    lane_outcome = {}
    for row in log:
        lane_outcome.setdefault(int(row[9]), int(row[8]))
    print(f"K8 finalize_pass{sfx}, {LANES} lanes, {FUSED_SLOTS} slots of "
          f"{shape}: bit-exact over 2 passes; pass 1 finalized {len(log)} "
          f"lanes (outcomes {outcomes}), FIFO {int(first['fifo_head'])}/"
          f"{int(first['fifo_n'])}, skipped as claimed "
          f"{first['claimed'].tolist()}"
          + (f"; lanes 16/17 on bf16(move_t): outcomes "
             f"{lane_outcome.get(16)}/{lane_outcome.get(17)}" if bf16
             else ""))
    require(outcomes == [1, 2, 3, 4, 5], "the crafted state missed an outcome")
    require(not bf16 or (lane_outcome.get(16) == fin_ops.FIN_WEAK
                         and lane_outcome.get(17) != fin_ops.FIN_WEAK),
            "K8: the dud kill and the verdict did not split on bf16(move_t)")

    # K8's work in pass 1: each counting finalization reads the lane's seeds,
    # the slot's segmentation and blocked volume once and writes its
    # claims; each reseed blanks a block (or the buffer) and the dedup grid.
    vol = int(np.prod(shape))
    block, _, reach = fin_ops.blank_geometry((fov,) * 3, (fov,) * 3, deltas,
                                             shape)
    counted = np.isin(log[:, 8], (fin_ops.FIN_SEGMENTED,
                                  fin_ops.FIN_TOO_SMALL))
    nbytes_moved = (5 + nbytes) * vol * int(counted.sum()) + 4 * int(
        log[log[:, 8] == fin_ops.FIN_SEGMENTED, 6].sum())
    got_lanes = ((first["iters"] == 0) & (first["status"] == 1)).cpu()
    span = lanes["maxp"] - lanes["minp"]
    for b in np.flatnonzero(got_lanes.numpy()):
        small = all(span[b] <= np.array(reach))
        nbytes_moved += nbytes * (int(np.prod(block)) if small else vol) + \
            int(np.prod(lanes["done"].shape[1:]))

    def restore():
        for work, saved in zip(ks, snap):
            for name in work:
                work[name].copy_(saved[name])

    fin_ms = time_restored(
        [lambda: tk.finalize_step(fin_ops.finalize_pass, *ks, blk, opts,
                                  **kw),
         lambda: tk.finalize_step(fin_ops.finalize_pass_plain, *ks, blk,
                                  opts, **kw)], restore)
    r = entry(0.0, *fin_ms, nbytes_moved)
    print(f"finalize_pass{sfx}: bit-exact; kernel {r['ms']:.4f} ms plain "
          f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']})")

    # A pass that finalizes nothing: the dud kill and the cond alone. With
    # every lane fresh it needs each lane's status, iters and fresh, and
    # writes alive.
    restore()
    _k8_empty(ks)
    ps = ({k: t.clone() for k, t in ks[0].items()},
          {k: t.clone() for k, t in ks[1].items()})
    empty = [lambda: tk.finalize_step(fin_ops.finalize_pass, *ks, blk, opts,
                                      **kw),
             lambda: tk.finalize_step(fin_ops.finalize_pass_plain, *ps, blk,
                                      opts, **kw)]
    got, want = empty[0](), empty[1]()
    torch.cuda.synchronize()
    require(int(got) == int(want) == 1 and all(
        tk.nan_equal(k[name], p[name]) for k, p in zip(ks, ps) for name in p),
            f"K8 finalize_pass{sfx}: the empty pass differs from plain")
    r["empty_ms"], r["empty_plain_ms"] = time_many(*empty)
    r["empty_bound_ms"] = bound_of(LANES * (4 + 4 + 1) + 4)[0]
    calls = 200
    t0 = time.perf_counter()
    for _ in range(calls):
        empty[0]()
    r["host_us"] = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    print(f"finalize_pass{sfx}, a pass that finalizes nothing ({LANES} "
          f"lanes running): kernel {r['empty_ms']:.4f} ms plain "
          f"{r['empty_plain_ms']:.4f} ms bound {r['empty_bound_ms']:.6f} ms; "
          f"the wrapper's host time {r['host_us']:.1f} us a call")
    del ks, ps, snap, blk
    torch.cuda.empty_cache()
    return {"finalize_pass" + sfx: r}


def phase_fused_kernels(dev):
    """K8 finalize_pass against its plain version (_k8_kernels) with float32
    and with bfloat16 seeds; K4 with the device segmentation and K7's
    batched masks at the same shapes. Median CUDA-event times of kernel and
    plain version, in turns."""
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    tk = _tests()
    shape = (FUSED_SUB,) * 3
    fov, deltas, Q = 33, (8, 8, 8), 32768
    results = {}
    for seed_dtype in (torch.bfloat16, torch.float32):
        results.update(_k8_kernels(dev, seed_dtype))

    # K4 with the device segmentation as a second claim source: the hop
    # slice's lanes on one slot of 82^3 with 20% of its voxels claimed.
    rng = np.random.RandomState(2)
    state = tk.to_torch(tk.crafted_lanes(rng, LANES, shape, Q, fov, deltas,
                                         MAX_ITERS), dev)
    seg = torch.from_numpy(np.where(rng.rand(1, *shape) < 0.2, 7, 0).astype(
        np.int32)).to(dev)
    small_fields = ("head", "status", "skip_threshold", "skip_invalid",
                    "skip_restricted", "executed", "pops")
    saved = {k: state[k].clone() for k in small_fields}
    grid_off = tk.grid_geometry(shape, deltas)[1]

    def pop(fn, work):
        def call():
            for k in small_fields:
                work[k].copy_(saved[k])
            return fn(work["blocked"], work["shapes"], work["seeds"],
                      work["sv"], work["qpos"], work["head"], work["tail"],
                      work["done"], work["start"], work["iters"],
                      work["status"], work["fresh"], work["skip_threshold"],
                      work["skip_invalid"], work["skip_restricted"],
                      work["executed"], work["pops"], move_threshold=tk.MOVE_T,
                      margin=(fov // 2,) * 3, deltas=deltas,
                      grid_offset=grid_off, max_iters=MAX_ITERS, seg=seg)
        return call

    plain_state = {k: v.clone() for k, v in state.items()}
    got = pop(hop_ops.hop_pop, state)()
    want = pop(hop_ops.hop_pop_plain, plain_state)()
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)) and all(
        tk.nan_equal(state[k], plain_state[k]) for k in state),
        "K4 with seg differs from plain")
    entries = int((state["pops"] - saved["pops"]).sum())
    pop_ms = time_pair(pop(hop_ops.hop_pop, state),
                       pop(hop_ops.hop_pop_plain, state))
    print(f"K4 hop_pop with seg, {LANES} lanes on {shape}: bit-exact, "
          f"{entries} entries examined; kernel {pop_ms[0]:.4f} ms plain "
          f"{pop_ms[1]:.4f} ms bound {bound_of(22 * entries)[0]:.5f} ms")
    results["hop_pop@seg"] = pop_ms

    # K7's batched masks: 24 finalization boxes of the 64 lanes' seeds.
    seeds = state["seeds"]
    brng = np.random.RandomState(3)
    sizes = brng.choice([64, 41, 17, 82], size=(24, 3))
    starts = [brng.randint(0, FUSED_SUB - sz + 1) for sz in sizes]
    box_lanes = brng.randint(0, LANES, size=24)
    origins = brng.randint(0, FUSED_SUB, size=(24, 3))
    mkw = dict(threshold=tk.SEG_T, move_threshold=tk.MOVE_T)
    args = (seeds, box_lanes, starts, sizes, origins)
    got = lane_ops.lane_masks(*args, **mkw)
    want = lane_ops.lane_masks_plain(*args, **mkw)
    require(torch.equal(got, want), "K7 batched masks differ from plain")
    masks_ms = time_pair(lambda: lane_ops.lane_masks(*args, **mkw),
                         lambda: lane_ops.lane_masks_plain(*args, **mkw))
    results["lane_masks"] = entry(0.0, *masks_ms,
                                  5 * int(np.prod(sizes, axis=1).sum()))
    r = results["lane_masks"]
    print(f"lane_masks: bit-exact; kernel {r['ms']:.4f} ms plain "
          f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']})")
    return results


def _request_text(image, out_dir, ckpt, model_args, min_size):
    """configs/inference_phantom.pbtxt's InferenceRequest on `image` with
    the given checkpoint, model and minimum segment size, as a text proto
    for the sharded CLI."""
    return "\n".join([
        f'image {{ hdf5: "{image}" }}', "image_mean: 128",
        "image_stddev: 33", 'seed_policy: "PolicyPeaks"',
        f'model_checkpoint_path: "{ckpt}"',
        'model_name: "convstack_3d.ConvStack3DFFNModel"',
        "model_args: " + json.dumps(json.dumps(model_args)),
        f'segmentation_output_dir: "{out_dir}"',
        "inference_options { init_activation: 0.95 pad_value: 0.05 "
        "move_threshold: 0.9 min_boundary_dist { x: 1 y: 1 z: 1 } "
        f"segment_threshold: 0.6 min_segment_size: {min_size} }}"])


def _sharded_args(request, edge, sub, overlap, lanes, slots, hops):
    x, y, z = (edge,) * 3 if np.isscalar(edge) else edge
    return [f"--inference_request={request}",
            f"--bounding_box=start {{ x:0 y:0 z:0 }} size {{ x:{x} "
            f"y:{y} z:{z} }}",
            f"--subvolume_size={sub},{sub},{sub}",
            f"--overlap={overlap},{overlap},{overlap}", f"--lanes={lanes}",
            f"--slots={slots}", f"--hops={hops}",
            f"--max_iters_per_segment={MAX_ITERS}", "--device=cuda"]


def _run_worker(argv, patches=()):
    """One worker run through the sharded CLI's entry point, in this
    process (so launches and CUDA events are visible); returns (wall
    seconds, the stats its JSON line printed)."""
    import contextlib
    import io
    from ffn_tpu_torch.cli import run_sharded_inference
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        with contextlib.redirect_stdout(out):
            run_sharded_inference.main(argv + ["--mode=worker"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    print(lines[0])
    return wall, json.loads(lines[-1])["stats"]


def _stitch(argv, output, as_process=True):
    """Stitch mode of the sharded CLI: as a user runs it (python -m), or
    through its entry point in this process, which skips the start-up."""
    t0 = time.perf_counter()
    if as_process:
        proc = subprocess.run(
            [sys.executable, "-m", "ffn_tpu_torch.cli.run_sharded_inference"]
            + argv + ["--mode=stitch", f"--output={output}"], cwd=REPO,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=REPO))
        require(proc.returncode == 0,
                f"stitch failed: {proc.stderr[-2000:]}")
        print(proc.stdout.strip().splitlines()[-1])
    else:
        from ffn_tpu_torch.cli import run_sharded_inference
        run_sharded_inference.main(argv + ["--mode=stitch",
                                           f"--output={output}"])
    return time.perf_counter() - t0, np.load(output)["segmentation"]


def _subvolumes(out_dir, edge, sub, overlap):
    """Per subvolume, in index order: (segmentation, origin rows (id, z, y,
    x, iterations), count counters) as the worker saved them."""
    from ffn_tpu_torch.inference import storage
    from ffn_tpu_torch.inference.counters import Counters
    from ffn_tpu_torch.utils import bounding_box
    calc = bounding_box.OrderlyOverlappingCalculator(
        bounding_box.BoundingBox(start=(0, 0, 0), size=(
            (edge,) * 3 if np.isscalar(edge) else edge)),
        [sub] * 3, [overlap] * 3)
    out = []
    for index in range(calc.num_sub_boxes()):
        corner = tuple(int(v) for v in
                       calc.index_to_sub_box(index).start[::-1])
        seg, origins = storage.load_segmentation(out_dir, corner,
                                                 split_cc=False)
        with np.load(storage.segmentation_path(out_dir, corner)) as data:
            counters = Counters()
            counters.loads(data["counters"])
            counts = {k: c.value for k, c in counters
                      if not k.endswith("-ms")}
        rows = np.array([(k, *o.start_zyx, o.iters)
                         for k, o in sorted(origins.items())], np.int64)
        out.append((seg.astype(np.int64), rows, counts))
    return out


def _fused(label, name, tmp, model_args, flags=(), size=None, patches=()):
    """One worker run of the sharded CLI in this process (phase 5's phantom,
    model-r2 with `model_args`, 82^3 subvolumes or the box's edge, overlap 32,
    64 lanes, 4 slots, 16 hops) over the box `size` (default: all). Returns
    dict(subs, moves, wall, argv, launches, peak)."""
    from ffn_tpu_torch import _build
    image = os.path.join(tmp, "phantom_s0.npy")   # phase 5's phantom
    sub = FUSED_SUB if size is None else min(FUSED_SUB, *size)
    size = size or np.load(image, mmap_mode="r").shape
    out_dir = os.path.join(tmp, name)
    argv = _sharded_args(
        _request_text(image, out_dir, os.path.join(
            REPO, "models", "phantom", "model-r2.npz"), model_args, 1000),
        size, sub, FUSED_OVERLAP, LANES, FUSED_SLOTS, HOPS) + list(flags)
    _build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    wall, stats = _run_worker(argv, patches)
    launches = dict(_build.launches)
    moves = stats.get("executed", 0)   # no stats from serial workers
    print(f"{label} ({size}): {moves} FOV moves in {wall:.3f} s wall, "
          f"{moves / wall:.2f} moves/s; " + (
              f"{stats['rounds']} rounds; occupancy "
              f"{stats['running_lane_rounds']}/{stats['lane_rounds']} "
              f"lane-rounds; fifo loaded/consumed {stats.get('fifo_loaded')}"
              f"/{stats.get('fifo_consumed')}; t_hops {stats['t_hops']:.3f} "
              f"t_seed {stats['t_seed']:.3f} t_ingest "
              f"{stats['t_ingest']:.3f} t_load {stats['t_load']:.3f} s; "
              if stats else "") + f"launches {launches}")
    return dict(subs=_subvolumes(out_dir, size, sub, FUSED_OVERLAP),
                moves=moves, wall=wall, argv=argv, launches=launches,
                peak=torch.cuda.max_memory_allocated())


def _fused_plain():
    """K4, K7 and K8 on their plain versions (the fused path's kernels but
    the conv and K5/K6, which the hop pairs hold)."""
    from ffn_tpu_torch.ops import finalize as fin_ops
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    return (_plain(hop_ops, "hop_pop") + _plain(fin_ops, "finalize_pass")
            + _plain(lane_ops, "lane_verdicts", "lane_mask", "lane_masks"))


# The fused pairs' box: one subvolume of 64^3.
FUSED_PAIR_BOX = (64, 64, 64)


def _corner(phantom):
    """_run_slice's box, gt and inner for the phantom's FUSED_PAIR_BOX
    corner: the kernel-vs-plain pairs of phases 16 and 18."""
    edge = FUSED_PAIR_BOX[0]
    return dict(box=FUSED_PAIR_BOX, inner=(slice(PHANTOM_PAD, edge),) * 3,
                gt=phantom["gt"][(slice(0, edge - PHANTOM_PAD),) * 3])


def phase_fused_slice(dev, tmp):
    """The fused path at full width in both finalize modes: the padded 100^3
    phantom (seed 0, 132^3) through the sharded CLI's worker mode (in this
    process), model-r2, 8 subvolumes of 82^3, 64 lanes, 4 slots, 16 hops,
    with device finalization (K8, K4 with the segmentation) and host
    finalization (K7's verdicts and masks), then stitched. Each mode again
    on FUSED_PAIR_BOX on kernels and with K4, K7, K8 plain: identical. 64
    lanes split cells as the JAX package's do (ROADMAP Queue 3), so each
    stitched agreement has a floor under its measured value; the serial
    workers (--no-fused), stitched, hold the quality gate's 0.95. Returns
    the full runs' launches (fused, fused_host)."""
    from ffn_tpu_torch.ops import finalize as fin_ops
    from tools import synthetic_em

    _, gt = synthetic_em.make_volume(size=PHANTOM_SIZE, seed=0,
                                     num_cells=PHANTOM_CELLS)
    model_args = {"depth": 12, "fov_size": [33] * 3, "deltas": [8] * 3}
    kernel_launches = {}
    for path, flags, floor, needed in (
            ("fused", [], FUSED_AGREE_FLOOR,
             ("conv3d_ndhwc_f32", "hop_pop", "hop_gather", "hop_update",
              "finalize_pass")),
            ("fused_host", ["--no-device_finalize"], FUSED_HOST_AGREE_FLOOR,
             ("conv3d_ndhwc_f32", "hop_pop", "hop_gather", "hop_update",
              "hop_screen", "lane_threshold", "lane_masks"))):
        probe = _K8Probe()
        run = _fused(f"{path} slice on kernels", path, tmp, model_args,
                     flags, patches=[probe.patch()])
        if probe.events:
            probe.report(f"the {path} slice")
        _require_launched(run["launches"], f"the {path} path", needed)
        kernel_launches[path] = run["launches"]
        stitch_s, stitched = _stitch(run["argv"], os.path.join(
            tmp, f"{path}.npz"), as_process=path == "fused")
        agree = _stitched_agreement(f"{path} slice", stitch_s, stitched, gt)
        _note(path, "float32", dict(run, agree=agree), stitched)
        require(agree >= floor, f"{path} slice agreement {agree} below its "
                                f"floor {floor}")
        _pair(f"the {path} slice on one subvolume", lambda label, sfx: _fused(
            f"{path} slice on one subvolume {label}", f"{path}_pair{sfx}", tmp,
            model_args, flags, FUSED_PAIR_BOX), _fused_plain(),
            keys=("subs", "moves"))

    run = _fused("sharded serial workers", "sharded_serial", tmp, model_args,
                 ["--no-fused"])
    stitch_s, stitched = _stitch(run["argv"], os.path.join(tmp, "serial.npz"),
                                 as_process=False)
    serial = _stitched_agreement(f"sharded serial workers "
                                 f"({run['wall']:.3f} s)", stitch_s, stitched,
                                 gt)
    require(serial >= 0.95, f"sharded serial agreement {serial} below the "
                            f"quality gate's 0.95")
    return kernel_launches


def _stitched_agreement(label, stitch_s, stitched, gt):
    """Prints a stitched volume's ground-truth agreement and, per cell, the
    share of its largest object and its count of objects over 1% of it;
    returns the agreement."""
    from tools import synthetic_em
    inner = stitched[(slice(PHANTOM_PAD, -PHANTOM_PAD),) * 3]
    agree = synthetic_em.object_level_agreement(
        gt.astype(np.uint64), inner.astype(np.uint64), min_size=1000)
    cells = []
    for cell in np.unique(gt[gt > 0]):
        ids, n = np.unique(inner[(gt == cell) & (inner > 0)],
                           return_counts=True)
        share = n / (gt == cell).sum()
        cells.append(f"{share.max():.3f}/{int((share > 0.01).sum())}")
    print(f"{label} stitch: {stitch_s:.3f} s; {len(np.unique(stitched)) - 1}"
          f" objects; ground-truth agreement {agree:.4f}; per cell, largest "
          f"object's share/objects over 1%: {' '.join(cells)}")
    return agree


def phase_fused_golden(dev, tmp):
    """The CI checkpoint's fused runs in both modes against the JAX package's
    (tests/golden/fused_ci_golden.npz): subvolumes, origins, counters and the
    stitched volume equal."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.cli import run_sharded_inference
    ref = np.load(os.path.join(REPO, "tests", "golden",
                               "fused_ci_golden.npz"))
    image = os.path.join(tmp, "fused_ci.npy")
    np.save(image, ref["image"])
    edge = ref["image"].shape[0]
    ckpt = os.path.join(REPO, "models", "phantom", "model-ci-tiny.npz")
    model_args = {"depth": 2, "fov_size": [17] * 3, "deltas": [6] * 3,
                  "features": 16}
    launches = {}
    for mode in ("devfin", "host"):
        out_dir = os.path.join(tmp, f"ci_{mode}")
        argv = _sharded_args(
            _request_text(image, out_dir, ckpt, model_args, 300), edge,
            CI_SUB, CI_OVERLAP, CI_LANES, FUSED_SLOTS, CI_HOPS)
        if mode == "host":
            argv.append("--no-device_finalize")
        _build.launches.clear()
        wall, stats = _run_worker(argv)
        launches[mode] = dict(_build.launches)
        subs = _subvolumes(out_dir, edge, CI_SUB, CI_OVERLAP)
        output = os.path.join(tmp, f"ci_{mode}.npz")
        run_sharded_inference.main(argv + ["--mode=stitch",
                                           f"--output={output}"])
        stitched = np.load(output)["segmentation"]
        want_origins = ref[f"{mode}_origins"]
        want_counts = json.loads(str(ref[f"{mode}_counters"]))
        same_seg = all(np.array_equal(s[0], w) for s, w in
                       zip(subs, ref[f"{mode}_seg"]))
        same_origins = all(
            np.array_equal(s[1], want_origins[want_origins[:, 0] == i, 1:])
            for i, s in enumerate(subs))
        same_counts = [s[2] for s in subs] == want_counts
        same_stitched = np.array_equal(stitched, ref[f"{mode}_stitched"])
        print(f"CI checkpoint, fused {mode}: {stats['executed']} moves in "
              f"{wall:.3f} s; against the JAX package's run: identical "
              f"subvolumes {same_seg}, origins {same_origins}, counters "
              f"{same_counts}, stitched volume {same_stitched} (the JAX "
              f"run was deterministic: "
              f"{bool(ref[f'{mode}_deterministic'])}); launches "
              f"{launches[mode]}")
        if bool(ref[f"{mode}_deterministic"]):
            require(same_seg and same_origins and same_counts
                    and same_stitched, f"the CI fused {mode} run differs "
                                       f"from the JAX package's")
        else:
            # The JAX driver's own test tolerance (tests/test_multi_canvas
            # .py:67-70): foreground mismatch < 2%, the same object count.
            for s, w in zip(subs, ref[f"{mode}_seg"]):
                a, b = s[0] > 0, w > 0
                require((a != b).sum() / max(a.sum(), 1) < 0.02,
                        f"the CI fused {mode} run is off the JAX package's")


def phase_fused_r2_reference(dev, tmp):
    """The JAX package's model-r2 run of the fused driver
    (tests/golden/fused_r2_golden.npz, `tests/make_torch_fused_golden.py
    --model r2`: a 64^3 phantom padded to 96^3, 8 subvolumes of 64^3, 64
    lanes, 4 slots, 16 hops, device finalization): the port must reach its
    stitched agreement, on K1 and on its plain version. Voxels may differ
    (the packages' depth-12 convolutions round differently and 64 racing
    lanes amplify it); the serial workers, stitched, hold 0.95."""
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from tools import synthetic_em
    ref = np.load(os.path.join(REPO, "tests", "golden",
                               "fused_r2_golden.npz"))
    image = os.path.join(tmp, "fused_r2.npy")
    np.save(image, ref["image"])
    edge = ref["image"].shape[0]
    ckpt = os.path.join(REPO, "models", "phantom", "model-r2.npz")
    model_args = {"depth": 12, "fov_size": [33] * 3, "deltas": [8] * 3}
    inner = (slice(PHANTOM_PAD, -PHANTOM_PAD),) * 3
    want_segs = ref["devfin_seg"]

    def foreground_off(segs):
        return max(float(((s > 0) != (w > 0)).sum()) / max(int(
            (w > 0).sum()), 1) for s, w in zip(segs, want_segs))

    runs = {}
    for label, flags, patches in (
            ("kernels", [], []),
            ("K1 plain", [], [mock.patch.object(
                convstack_3d, "conv3d_ndhwc_f32",
                conv3d.conv3d_ndhwc_plain)]),
            ("serial workers", ["--no-fused"], [])):
        out_dir = os.path.join(tmp, f"r2_{len(runs)}")
        argv = _sharded_args(
            _request_text(image, out_dir, ckpt, model_args, 1000), edge,
            R2_SUB, R2_OVERLAP, LANES, FUSED_SLOTS, HOPS) + flags
        wall, stats = _run_worker(argv, patches)
        _, stitched = _stitch(argv, f"{out_dir}.npz", as_process=False)
        agree = synthetic_em.object_level_agreement(
            ref["gt"].astype(np.uint64), stitched[inner].astype(np.uint64),
            min_size=1000)
        segs = [s[0] for s in _subvolumes(out_dir, edge, R2_SUB,
                                          R2_OVERLAP)]
        runs[label] = (agree, segs)
        print(f"model-r2 fused reference (96^3, 8 subvolumes of 64^3, 64 "
              f"lanes), {label}: {stats.get('executed', '-')} moves in "
              f"{wall:.3f} s, {len(np.unique(stitched)) - 1} stitched "
              f"objects, ground-truth agreement {agree:.4f}; against the "
              f"JAX package's run: identical subvolumes "
              f"{sum(np.array_equal(s, w) for s, w in zip(segs, want_segs))}"
              f"/{len(segs)}, largest foreground mismatch "
              f"{foreground_off(segs):.5f}")
    jax_moves = sum(c.get("fov-moves", 0)
                    for c in json.loads(str(ref["devfin_counters"])))
    want = float(ref["devfin_agreement"])
    spread = max(float(((a > 0) != (b > 0)).sum()) / max(int((b > 0).sum()),
                                                         1)
                 for a, b in zip(runs["K1 plain"][1], runs["kernels"][1]))
    print(f"model-r2 fused reference: the JAX package's run {jax_moves} "
          f"moves, {len(np.unique(ref['devfin_stitched'])) - 1} stitched "
          f"objects, agreement {want:.4f}; within the port, K1 against its "
          f"plain version: largest foreground mismatch {spread:.5f}")
    for label in ("kernels", "K1 plain"):
        require(runs[label][0] == want,
                f"model-r2 fused agreement {runs[label][0]} on {label}, "
                f"{want} in the JAX package's run")
    require(runs["serial workers"][0] >= 0.95,
            f"model-r2 serial workers' agreement {runs['serial workers'][0]}"
            f" below the quality gate's 0.95")


def phase_golden(dev):
    from ffn_tpu_torch.models import convstack_3d, params_io
    fx = np.load(os.path.join(REPO, "tests", "golden",
                              "fib25_logits_golden.npz"))
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33, 33, 33], deltas=[8, 8, 8], depth=12, features=32)
    model.load_params(params_io.load_params_npz(
        os.path.join(REPO, "models", "fib25", "model-27465036.npz")))
    model.to(dev)
    out = model.apply(torch.from_numpy(fx["image"]).to(dev),
                      torch.from_numpy(fx["seed_logits"]).to(dev))
    out = out.cpu().numpy()
    err = float(np.abs(out - fx["logits"]).max())
    print(f"fib25 golden (depth 12, 32 features, 33^3) on the kernel path: "
          f"max_abs_err {err:.3e} vs the JAX package's logits (atol 2e-4)")
    require(out.shape == fx["logits"].shape and np.isfinite(out).all(),
            "fib25 golden: bad output")
    require(err <= 2e-4, f"fib25 golden: error {err} above 2e-4")


def _settings(image_path, out_dir):
    """configs/inference_phantom.pbtxt's settings, on the phantom."""
    from ffn_tpu_torch.cli.run_inference import parse_request
    from ffn_tpu_torch.inference import settings as settings_lib
    settings = settings_lib.InferenceSettings.from_proto(parse_request(
        "@" + os.path.join(REPO, "configs", "inference_phantom.pbtxt")))
    return dataclasses.replace(
        settings, image=image_path, segmentation_output_dir=out_dir,
        model_checkpoint_path=os.path.join(REPO,
                                           settings.model_checkpoint_path))


def _run_slice(label, settings, dev, box, gt, inner, hops=None,
               probe=None, max_iters=MAX_ITERS):
    """One Runner.run over the phantom: serial Canvas (hops None), hop path or,
    hops 0, round path; `probe` (_HopProbe) times the batched calls. Returns
    dict(seg, moves, wall, agree, rounds, origins, counts, seed_dtype)."""
    from ffn_tpu_torch.inference import runner as runner_lib
    from ffn_tpu_torch.inference import storage
    from tools import synthetic_em

    runner = runner_lib.Runner(device=dev)
    if hops is not None:
        runner.canvas_defaults.update(hops=hops,
                                      max_iters_per_segment=max_iters)
    runner.start(settings)
    patches = probe.patches(runner, hops) if probe is not None else []
    for p in patches:
        p.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        canvas = runner.run((0, 0, 0), box, keep_probability_maps=False)
        torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    wall = time.perf_counter() - t0
    kind = {None: "Canvas", 0: "BatchCanvas"}.get(hops, "HopBatchCanvas")
    require(type(canvas).__name__ == kind, f"the {label} run ran "
                                           f"{type(canvas).__name__}")
    seeds = {"Canvas": "_seed_dev", "BatchCanvas": "_seeds_dev"}.get(kind)
    seeds = getattr(canvas, seeds) if seeds else canvas._state.seeds
    seg_path = storage.segmentation_path(settings.segmentation_output_dir,
                                         (0, 0, 0))
    with np.load(seg_path, allow_pickle=True) as data:
        seg = data["segmentation"].astype(np.uint64)[inner]
    c = runner.counters
    counts = {n: v.value for n, v in c if not n.endswith("-ms")}
    moves = counts["fov-moves" if hops is not None else "update_at-calls"]
    rounds = counts["predict-calls"]
    predict_s = c["predict-time-ms"].value / 1e3
    agree = synthetic_em.object_level_agreement(gt.astype(np.uint64), seg,
                                                min_size=1000)
    print(f"{kind} {label}: {moves} FOV moves in {rounds} predict calls "
          f"({moves / max(rounds, 1):.2f} per call), {wall:.3f} s wall, "
          f"{moves / wall:.2f} moves/s; predict {predict_s:.3f} s, the "
          f"rest {wall - predict_s:.3f} s; {len(np.unique(seg[seg > 0]))} "
          f"objects, ground-truth agreement {agree:.4f}; counters "
          + ", ".join(f"{k} {counts[k]}" for k in (
                  "seed_got_too_weak", "screened-weak-seeds",
                  "skip_threshold", "iter-cap-hit", "queue-stall-drains",
                  "relaxed-deferral-seeds") if k in counts))
    return dict(seg=seg, moves=moves, wall=wall, agree=agree, rounds=rounds,
                origins={k: (tuple(int(v) for v in o.start_zyx), o.iters)
                         for k, o in canvas.origins.items()},
                counts=counts, seed_dtype=seeds.dtype)


def _same(a, b):
    """Equality of run results: arrays voxel for voxel, containers item for
    item."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _plain(mod, *names):
    """Patches of `mod`'s kernel wrappers by their plain versions."""
    return [mock.patch.object(mod, n, getattr(mod, n + "_plain"))
            for n in names]


def _pair(path, run, plain, keys=("seg", "moves", "origins", "counts")):
    """run(label, suffix) on the kernels, then with the `plain` patches
    (kernels on their plain versions): the two must agree on `keys`.
    Returns the kernel run's result and its launches."""
    from ffn_tpu_torch import _build
    _build.launches.clear()
    got = run("on kernels", "")
    launches = dict(_build.launches)
    with contextlib.ExitStack() as stack:
        for p in plain:
            stack.enter_context(p)
        want = run("on plain versions", "_plain")
    same = {k: _same(got[k], want[k]) for k in keys}
    print(f"{path}, kernels vs plain versions: identical {same}; kernel "
          f"launches {launches}")
    require(all(same.values()), f"the {path} run on kernels differs from "
                                f"the plain versions: {same}")
    return got, launches


def _phantom(tmp, seed):
    """The repo's padded 100^3 quality-gate phantom (tools/quality_eval.py,
    Q_SIZE=100 Q_PAD_IMAGE=16: 120 cells per 250^3 scaled) for `seed`,
    saved as .npy; returns (its path, dict(box, gt, inner))."""
    sys.path.insert(0, REPO)
    from tools import synthetic_em
    image, gt = synthetic_em.make_volume(size=PHANTOM_SIZE, seed=seed,
                                         num_cells=PHANTOM_CELLS)
    raw = np.pad(image, PHANTOM_PAD, mode="reflect")
    path = os.path.join(tmp, f"phantom_s{seed}.npy")
    np.save(path, raw)
    print(f"phantom seed {seed}: {PHANTOM_SIZE}^3 with {PHANTOM_CELLS} "
          f"cells, reflect-padded by {PHANTOM_PAD} to {raw.shape}")
    return path, dict(box=raw.shape, gt=gt,
                      inner=(slice(PHANTOM_PAD, -PHANTOM_PAD),) * 3)


def phase_slice(dev, tmp):
    """The serial slice (Canvas -> K2 -> K1 -> K3) with the request's checkpoint
    on kernels and plain, identical; then model-r2, held to 0.95. Returns
    (launches, the phantom, model-r2's settings, its segmentation)."""
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import step as step_ops

    image_path, phantom = _phantom(tmp, seed=0)
    settings = _settings(image_path, os.path.join(tmp, "kernels"))
    got, launches = _pair("the serial slice", lambda label, sfx: _run_slice(
        label, dataclasses.replace(settings, segmentation_output_dir=(
            os.path.join(tmp, "serial" + sfx))), dev, **phantom),
        [mock.patch.object(convstack_3d, "conv3d_ndhwc_f32",
                           conv3d.conv3d_ndhwc_plain)]
        + _plain(step_ops, "step_gather", "step_update"), keys=("seg",))
    require(got["seg"].any(), "the slice segmented no object")
    _require_launched(launches, "the serial path",
                      ("conv3d_ndhwc_f32", "step_gather", "step_update"))

    # The same slice with the flagship phantom checkpoint, held to the
    # repo's quality-gate floor (tests/test_shipped_checkpoint.py).
    r2 = dataclasses.replace(
        settings, segmentation_output_dir=os.path.join(tmp, "r2"),
        model_checkpoint_path=os.path.join(REPO, "models", "phantom",
                                           "model-r2.npz"))
    run = _run_slice("with models/phantom/model-r2.npz on kernels", r2, dev,
                     **phantom)
    require(run["agree"] >= 0.95, f"model-r2 agreement {run['agree']} below "
                                  f"the quality gate's 0.95")
    _note("serial", "float32", run)
    return launches, phantom, r2, run["seg"]


def _note(path, precision, run, seg=None):
    """Keeps a slice's rate, objects and agreement for phase 18."""
    seg = run["seg"] if seg is None else seg
    SLICE_RATES[path, precision] = (run["moves"] / run["wall"],
                                    len(np.unique(seg[seg > 0])),
                                    run["agree"])


def _require_launched(launches, path, names, absent=()):
    for name in names:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on {path}")
    for name in absent:
        require(launches.get(name, 0) == 0, f"{path} launched {name}")


class _HopProbe:
    """Device time of each batched-path call by CUDA events (recorded
    around the call, no synchronization), and the conv batch of each model
    call."""

    def __init__(self):
        self.events = {}
        self.batches = []     # (N, screening) per model.apply
        self.candidates = 0   # seeds given to screen_seeds
        self._screening = False

    def patches(self, runner, hops):
        """Patches of the hop (or, hops 0, round) path's kernels and the
        model."""
        from ffn_tpu_torch.ops import hop as hop_ops
        from ffn_tpu_torch.ops import lane as lane_ops
        from ffn_tpu_torch.ops import select as select_ops
        names = [(select_ops, "select_gather"), (select_ops, "select_update")]
        if hops:
            names = [(hop_ops, n) for n in ("hop_pop", "hop_gather",
                                            "hop_update", "hop_screen")] + [
                (lane_ops, "lane_verdicts"), (lane_ops, "lane_mask")]
        out = [mock.patch.object(mod, name, self.wrap(name, getattr(mod,
                                                                    name)))
               for mod, name in names]
        out.append(mock.patch.object(runner.model, "apply", self.wrap(
            "model.apply", runner.model.apply)))
        screen = runner.engine.screen_seeds

        def counted(image, positions, *args, **kwargs):
            self.candidates += len(np.asarray(positions).reshape(-1, 3))
            return screen(image, positions, *args, **kwargs)
        return out + [mock.patch.object(runner.engine, "screen_seeds",
                                        counted)]

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            if name == "hop_gather":
                self._screening = args[4] is None   # no seeds: screening
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            if name == "model.apply":
                self.batches.append((args[0].shape[0], self._screening))
            return out
        return timed

    def device_ms(self):
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.events.items()}

    def report(self, path, wall, calls):
        """Prints each probed call's device ms against the wall; returns
        them by name."""
        ms = self.device_ms()
        n = len(self.events[calls])
        device = sum(ms.values())
        print(f"{path} device ms by call (CUDA events): " + ", ".join(
            f"{name} {t:.1f} ({t / n:.4f}/{calls})"
            for name, t in ms.items())
            + f"; sum {device:.1f} ms of {1e3 * wall:.1f} ms wall: host "
              f"and idle {1e3 * wall - device:.1f} ms")
        return ms


class _K8Probe:
    """K8's device time by CUDA events around each call (no
    synchronization) and the finalizations (log rows) each call wrote."""

    def __init__(self):
        self.events = []   # (start, end, log_n before, log_n after)

    def patch(self):
        from ffn_tpu_torch.ops import finalize as fin_ops
        inner = fin_ops.finalize_pass

        def timed(state, fstate, *args, **kwargs):
            before = fstate.log_n.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(state, fstate, *args, **kwargs)
            end.record()
            self.events.append((start, end, before, fstate.log_n.clone(),
                                state.seeds.dtype))
            return out
        return mock.patch.object(fin_ops, "finalize_pass", timed)

    def report(self, path):
        """Prints K8's launches, device ms a launch and finalizations a
        launch on `path`; returns them."""
        torch.cuda.synchronize()
        n = len(self.events)
        ms = sum(s.elapsed_time(e) for s, e, *_ in self.events)
        fins = int(sum(int(a - b) for _, _, b, a, _ in self.events))
        name = "finalize_pass" + ("_bf16" if self.events[0][4] ==
                                  torch.bfloat16 else "")
        print(f"K8 {name} in {path}: {n} launches, {ms:.1f} device ms, "
              f"{ms / n:.4f} ms a launch, {fins / n:.3f} finalizations a "
              f"launch ({fins} in all)")
        return dict(launches=n, ms=ms, fins=fins)


def phase_hop_slice(dev, phantom, r2, seg_serial, tmp):
    """64 lanes, hops 16, model-r2, probed; the gate's pair on its seed-11
    phantom at 8 lanes, and on its 64^3 corner with K4-K7 on kernels and
    plain, identical. Returns launches."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops

    settings = dataclasses.replace(
        r2, concurrent_requests=LANES,
        segmentation_output_dir=os.path.join(tmp, "hop"))
    probe = _HopProbe()
    _build.launches.clear()
    run = _run_slice("hop slice with model-r2 on kernels", settings, dev,
                     **phantom, hops=HOPS, probe=probe)
    launches = dict(_build.launches)
    print(f"kernel launches on the hop path: {launches}")
    _require_launched(launches, "the hop path", (
        "conv3d_ndhwc_f32", "hop_pop", "hop_gather", "hop_update",
        "hop_screen", "lane_threshold"))
    lane_evals = sum(n for n, _ in probe.batches)
    buckets = [n for n, screen in probe.batches if not screen]
    screens = [n for n, screen in probe.batches if screen]
    print(f"hops {len(probe.events['hop_pop'])}, mean conv bucket "
          f"{statistics.mean(buckets):.2f} lanes over {len(buckets)} hop "
          f"convs; screen batches {len(screens)} ({sum(screens)} "
          f"lane-evaluations for {probe.candidates} candidates); conv "
          f"lane-evaluations {lane_evals} ({run['moves'] / lane_evals:.3f} "
          f"executed moves per lane-evaluation)")
    probe.report("hop slice", run["wall"], "hop_pop")
    _note("hop", "float32", run)
    require(run["agree"] >= 0.95, f"hop slice model-r2 agreement "
                                  f"{run['agree']} below the quality gate's "
                                  f"0.95")
    # Printed, not required: at 48-64 lanes on these 8-cell phantoms the
    # batched path splits a cell the serial one keeps whole (0.4762 here,
    # 0.8889 on the gate's phantom, NVIDIA H100 80GB HBM3, 700 W), and so
    # does the JAX package: phase_gate_reference holds the port to its
    # 64-lane run, which scores 0.8571.
    _lanes_vs_serial(LANES, "model-r2, the slice's phantom (seed 0)",
                     phantom, seg_serial, run["seg"])

    # The quality gate's batched-vs-serial pair (tools/quality_eval.py
    # :193-219) on its held-out seed-11 phantom, at 8 lanes, where lanes do
    # not outnumber the cells: held to the gate's 0.99. The 8-lane run
    # again with K4-K7 on their plain versions must be identical.
    path, gate = _phantom(tmp, seed=11)
    gate_r2 = dataclasses.replace(r2, image=path)
    seg_1 = _run_slice(
        "gate phantom (seed 11), serial, model-r2", dataclasses.replace(
            gate_r2, segmentation_output_dir=os.path.join(tmp, "gate_1")),
        dev, **gate)["seg"]
    def gate_run(label, sfx, where):
        return _run_slice(
            f"gate phantom (seed 11), {GATE_LANES} lanes, model-r2, {label}",
            dataclasses.replace(gate_r2, concurrent_requests=GATE_LANES,
                                segmentation_output_dir=os.path.join(
                                    tmp, "gate_n" + sfx)), dev, **where,
            hops=HOPS)

    gate_n = gate_run("on kernels", "", gate)
    edge = FUSED_PAIR_BOX[0]
    _pair(f"the gate's 8-lane hop slice on {edge}^3", lambda label, sfx:
          gate_run(f"{edge}^3, {label}", "_pair" + sfx, _corner(gate)),
          _plain(hop_ops, "hop_pop", "hop_gather", "hop_update", "hop_screen")
          + _plain(lane_ops, "lane_verdicts", "lane_mask"))
    cells = _lanes_vs_serial(GATE_LANES, "model-r2, the gate's phantom",
                             gate, seg_1, gate_n["seg"])
    require(gate_n["agree"] >= 0.95 and cells >= 0.99,
            f"gate phantom: agreement {gate_n['agree']}, lanes-vs-serial "
            f"{cells}")
    return launches


def phase_gate_reference(dev, r2, tmp):
    """The gate pair with the CI checkpoint against the JAX package's CPU run
    (tests/golden/gate_ci_lanes_golden.npz, make_torch_gate_golden.py):
    serial and 64 lanes equal in voxels, origins and moves, on the golden's
    own phantom (another numpy may draw it a voxel differently)."""
    from ffn_tpu_torch.inference import runner as runner_lib
    ref = np.load(os.path.join(REPO, "tests", "golden",
                               "gate_ci_lanes_golden.npz"))
    path = os.path.join(tmp, "gate_ci.npy")
    np.save(path, ref["image"])
    gate = dict(box=ref["image"].shape, gt=ref["gt"],
                inner=(slice(PHANTOM_PAD, -PHANTOM_PAD),) * 3)
    ci = dataclasses.replace(
        r2, image=path, model_checkpoint_path=os.path.join(
            REPO, "models", "phantom", "model-ci-tiny.npz"),
        model_args='{"depth": 2, "fov_size": [17, 17, 17], '
                   '"deltas": [6, 6, 6], "features": 16}')
    segs = {}
    for lanes in (1, LANES):
        runner = runner_lib.Runner(device=dev)
        runner.canvas_defaults["max_iters_per_segment"] = MAX_ITERS
        runner.start(dataclasses.replace(
            ci, concurrent_requests=lanes,
            segmentation_output_dir=os.path.join(tmp, f"ci{lanes}")))
        t0 = time.perf_counter()
        canvas = runner.run((0, 0, 0), gate["box"],
                            keep_probability_maps=False)
        wall = time.perf_counter() - t0
        seg = np.maximum(canvas.segmentation, 0)
        origins = np.array([(k, *o.start_zyx, o.iters)
                            for k, o in sorted(canvas.origins.items())],
                           np.int64)
        moves = runner.counters[
            "fov-moves" if lanes > 1 else "update_at-calls"].value
        same = (np.array_equal(seg, ref[f"seg{lanes}"]),
                np.array_equal(origins, ref[f"origins{lanes}"]),
                moves == int(ref[f"moves{lanes}"]))
        print(f"CI checkpoint on the gate's phantom, {lanes} lanes: {moves} "
              f"moves in {wall:.3f} s; against the JAX package's run: "
              f"identical voxels {same[0]}, origins {same[1]}, moves "
              f"{same[2]}")
        require(all(same), f"the CI checkpoint's gate run at {lanes} "
                           f"lanes differs from the JAX package's")
        segs[lanes] = seg.astype(np.uint64)[gate["inner"]]
    _lanes_vs_serial(LANES, "CI checkpoint, the gate's phantom (as the JAX "
                     "package's own run)", gate, segs[1],
                     segs[LANES])


# -- the round-based batched path (phases 3, 12 and 13) -----------------------


def phase_select_kernels(dev):
    """K13 and K14 against their plain versions, bit for bit, on a crafted
    64-lane round on 132^3 (tests/test_torch_kernels.py crafted_select:
    NaN seeds and candidates, weak and NaN starts, inactive lanes, faces,
    out-of-volume candidates, tied and NaN logits) in select mode (K = 4)
    and step_batch's fixed mode (K = 1), with float32 and bfloat16 seeds
    (bf16_select_edges: values on the thresholds' rounding edges); times
    and bounds of the select-mode rounds."""
    from ffn_tpu_torch.ops import select as select_ops
    tk = _tests()
    rng = np.random.RandomState(5)
    vol = (PHANTOM_SIZE + 2 * PHANTOM_PAD,) * 3
    fov, deltas, nvox = 33, (8, 8, 8), 33 ** 3
    image = torch.from_numpy(rng.randn(*vol).astype(np.float32)).to(dev)
    results = {}
    for seed_dtype in (torch.float32, torch.bfloat16):
        bf16 = seed_dtype == torch.bfloat16
        sfx, nbytes = ("_bf16", 2) if bf16 else ("", 4)
        move_t = tk.MOVE_T_LO if bf16 else tk.MOVE_T
        logits = tk.tied_logits(rng, LANES, fov)
        if bf16:
            logits += rng.randn(*logits.shape).astype(np.float32) * 1e-3
        logits[3, 4, 4, 1] = np.nan
        logits = torch.from_numpy(logits).to(dev)
        kw = dict(fov=fov, pred=fov, deltas=deltas, disco=0.0,
                  move_threshold=move_t)
        for mode, K in (("fixed", 1), ("select", 4)):
            seeds, packed = tk.crafted_select(rng, LANES, K, vol,
                                              mode == "fixed")
            if bf16:
                tk.bf16_select_edges(rng, seeds, packed, move_t)
            pk = torch.from_numpy(packed).to(dev)
            ks = torch.from_numpy(seeds).to(dev).to(seed_dtype)
            ps = ks.clone()
            del seeds
            got = tk.select_round(select_ops, image, ks, pk, logits, **kw)
            want = tk.select_round(tk._PlainSelect, image, ps, pk, logits,
                                   **kw)
            torch.cuda.synchronize()
            same = all(g.shape == w.shape and tk.nan_equal(g, w)
                       for g, w in zip(got, want)) and tk.nan_equal(ks, ps)
            rec = want[2].cpu().numpy()
            n_exec = int(rec[:, 0].sum())
            print(f"K13 select_gather{sfx} + K14 select_update{sfx}, {mode} "
                  f"mode (K={K}), {LANES} lanes on {vol}: bit-exact {same}; "
                  f"{n_exec} lanes executed, chosen "
                  f"{sorted(set(rec[:, 1].tolist()))}")
            require(same, f"K13/K14{sfx} differ from their plain versions "
                          f"in {mode} mode")
            require(0 < n_exec < LANES or mode == "fixed",
                    "the crafted round executed no lane or every lane")
            del ps, want
        gkw = dict(image_size=(fov,) * 3, seed_size=(fov,) * 3,
                   move_threshold=move_t, pad=tk.PAD)
        # K13 reads each lane's K + 1 seed values, its image and seed
        # patches and its packed row, and writes both float32 model inputs
        # and its record.
        results["select_gather" + sfx] = entry(0.0, *time_pair(
            lambda: select_ops.select_gather(image, ks, pk, **gkw),
            lambda: select_ops.select_gather_plain(image, ks, pk, **gkw)),
            LANES * ((12 + nbytes) * nvox + nbytes * (K + 1)
                     + 4 * pk.shape[1] + 24))
        rec = got[2]
        ukw = dict(pred_size=(fov,) * 3, deltas=deltas,
                   move_threshold=move_t, disco_threshold=0.0)
        # K14 reads each lane's logits crop, its old box and its record and
        # writes its float32 masked crop and packed row, and the box where
        # the lane executed.
        results["select_update" + sfx] = entry(0.0, *time_pair(
            lambda: select_ops.select_update(logits, ks, rec, **ukw),
            lambda: select_ops.select_update_plain(logits, ks, rec, **ukw)),
            LANES * ((8 + nbytes) * nvox + 24 + 120) + n_exec * nbytes * nvox)
        for name in ("select_gather" + sfx, "select_update" + sfx):
            r = results[name]
            print(f"{name} at {LANES} lanes on {vol} (select mode, {n_exec} "
                  f"executing): kernel {r['ms']:.4f} ms plain "
                  f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})")
        del ks, pk, logits, got
        torch.cuda.empty_cache()
    return results


def _k15_layers(gen, dt, ns, timed, entry_n):
    """K15 in `dt` per layer kind at each N in `ns` against its plain
    version: one ulp per rounding (k15_tolerance), at most DIFFER_SHARE
    differing, the float64 sums' rounding, a repeat and (N=64) sample 17
    alone bit for bit; times the kinds `timed[n]` beside its plain version,
    cuDNN's conv3d and K1; returns the kernel's entry (block_a at
    entry_n)."""
    import torch.nn.functional as F
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import conv3d_bf16_check as check
    label, out, err = "conv3d_ndhwc_" + conv3d.SUFFIX[dt], None, 0.0
    for n in ns:
        for name in ("conv0_a", "block_a", "block_b", "conv_lom"):
            k, cin, cout, pre, post, rdt, _ = check.K15_CASES[name]
            x, w, b, r = check.k15_inputs(gen, n, (33, 33, 33), name, dt)
            kw = dict(pre_relu=pre, post_relu=post, residual=r)
            got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
            want = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
            delta = (got.float() - want.float()).abs()
            differ = float((delta > 0).float().mean())
            worst = float((delta / check.k15_tolerance(x, w, b, **kw)).max())
            off = check.differ_share(
                got, check.conv3d_ndhwc_bf16_exact(x, w, b, **kw))
            err = max(err, float(delta.max()))
            one = n != 64 or torch.equal(conv3d.conv3d_ndhwc_bf16(
                x[17:18].clone(), w, b, pre_relu=pre, post_relu=post,
                residual=None if r is None else r[17:18].clone())[0],
                got[17])
            print(f"K15 {label} N={n} {name}: {differ:.3e} of outputs "
                  f"differ from plain, max {worst:.3f} of the tolerance; "
                  f"{off} off the float64 sums' rounding")
            require(got.dtype == want.dtype and got.shape == want.shape
                    and bool(torch.isfinite(got).all()) and worst <= 1.0
                    and differ <= check.DIFFER_SHARE and off == 0.0 and one
                    and torch.equal(got, conv3d.conv3d_ndhwc_bf16(
                        x, w, b, **kw)),
                    f"K15 {label} N={n} {name} against plain or exact")
            del got, want, delta
            if name not in timed.get(n, ()):
                continue
            xc = x.to(dt).permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            xf, wf, bf = x.float(), w.float(), b.float()
            rf = None if r is None else r.float()
            ms, plain_ms, lib_ms, k1_ms = time_many(
                lambda: conv3d.conv3d_ndhwc_bf16(x, w, b, **kw),
                lambda: conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw),
                lambda: F.conv3d(xc, wc, b, padding=k // 2),
                lambda: conv3d.conv3d_ndhwc_f32(
                    xf, wf, bf, pre_relu=pre, post_relu=post, residual=rf),
                reps=REPS if name == "block_a" else 5)
            work = k15_work(n, k, cin, cout, x.element_size(),
                            0 if r is None else r.element_size(),
                            4 if rdt == torch.float32 else 2)
            e = entry(0.0, ms, plain_ms, *work, library_ms=lib_ms,
                      peak=BF16_FLOPS)
            print(f"K15 {label} N={n} {name}: kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms library (cuDNN conv3d) {lib_ms:.4f} "
                  f"ms K1 float32 {k1_ms:.4f} ms bound {e['bound_ms']:.4f} "
                  f"ms ({e['bound_by']}): {work[1] / ms / 1e9:.1f} TFLOP/s")
            if n == entry_n and name == "block_a":
                out = e
            del xc, wc, xf, wf, bf, rf
        torch.cuda.empty_cache()
    out["max_abs_err"] = err
    return {label: out}


def phase_bf16_kernels(dev):
    """K15 in bfloat16 (_k15_layers) at N = 1, 8, 64, 256, timed at N=1
    and 64; the depth-12 model-r2 stack at N=64 within 2^-6 of max|plain
    logit|, equal to the float64 stack, N=1 samples equal to the batch's."""
    from ffn_tpu_torch.models import convstack_3d, params_io
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import conv3d_bf16_check as check

    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    kinds = ("conv0_a", "block_a", "block_b", "conv_lom")
    results = _k15_layers(gen, torch.bfloat16, K15_NS,
                          {1: kinds, LANES: kinds}, LANES)

    fov, deltas = 33, [8, 8, 8]
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[fov] * 3, deltas=deltas, depth=12, dtype="bfloat16")
    model.load_params(params_io.load_params_npz(
        os.path.join(REPO, "models", "phantom", "model-r2.npz")))
    model.to(dev)
    img = randn(LANES, fov, fov, fov, 1)
    sd = randn(LANES, fov, fov, fov, 1, scale=3.0)
    batch = model.apply(img, sd)
    # The plain stack on the CPU, the version the CPU tests hold to flax's
    # (bound 2^-6 max|logit|); F.conv3d's float32 sums on the card
    # (cuDNN) are one more order, printed beside it. The exact stack (float64
    # sums) is K15's function, held bit for bit.
    model.to("cpu")
    plain = model.apply(img.cpu(), sd.cpu()).to(dev)
    model.to(dev)
    with mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                           conv3d.conv3d_ndhwc_bf16_plain):
        card = model.apply(img, sd)
    with mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                           check.conv3d_ndhwc_bf16_exact):
        exact = model.apply(img, sd)
    stack_err = float((batch - plain).abs().max())
    bound = K15_STACK_TOL * float(plain.abs().max())
    print(f"K15 stack (model-r2, N={LANES}): max_abs_err {stack_err:.4e} "
          f"against the CPU's plain stack (bound {bound:.4e}), "
          f"{float((batch != plain).float().mean()):.4e} differ; the card's "
          f"plain stack {float((card - plain).abs().max()):.4e}; K15 against "
          f"it {float((batch - card).abs().max()):.4e}; equal to the "
          f"float64 stack: {torch.equal(batch, exact)}")
    require(batch.dtype == torch.float32 and
            bool(torch.isfinite(batch).all()) and stack_err <= bound,
            f"K15 stack at N={LANES}: error {stack_err} above {bound}")
    require(torch.equal(batch, exact), f"K15 stack at N={LANES} differs "
                                       f"from the stack with float64 sums")
    for i in (0, 17, LANES - 1):
        one = model.apply(img[i:i + 1].clone(), sd[i:i + 1].clone())
        require(torch.equal(one[0], batch[i]),
                f"K15: sample {i} at N=1 differs from N={LANES}")
    print(f"K15 conv stack (depth 12, 33^3): samples 0, 17, {LANES - 1} at "
          f"N=1 bit-identical to the same samples at N={LANES}")
    return results


def phase_round_slice(dev, phantom, r2, seg_serial, tmp):
    """The round-based slice (model-r2, float32, hops 0, 8 lanes: K13 -> K1 ->
    K14) on kernels, probed, and on a 64^3 corner on kernels and with
    K13/K14 plain, identical; then 64 lanes. Returns the 8-lane run's
    launches."""
    from ffn_tpu_torch.ops import select as select_ops

    from ffn_tpu_torch import _build

    settings = dataclasses.replace(r2, concurrent_requests=ROUND_LANES)
    probe = _HopProbe()

    def run_round(label, sfx, where, probe=None):
        return _run_slice(
            f"{ROUND_LANES} lanes, model-r2, {label}", dataclasses.replace(
                settings, segmentation_output_dir=os.path.join(
                    tmp, "round" + sfx)), dev, **where, hops=0, probe=probe)

    _build.launches.clear()
    run = run_round("on kernels", "", phantom, probe)
    launches = dict(_build.launches)
    edge = FUSED_PAIR_BOX[0]
    _pair(f"the round slice on {edge}^3", lambda label, sfx: run_round(
        f"{edge}^3, {label}", "_pair" + sfx, _corner(phantom)),
        _plain(select_ops, "select_gather", "select_update"))
    _require_launched(launches, "the round path", (
        "conv3d_ndhwc_f32", "select_gather", "select_update",
        "lane_threshold"))
    require(launches["select_gather"] == launches["select_update"],
            "K13 and K14 launched unequal times")
    ms = probe.report("round slice", run["wall"], "select_gather")
    wall_ms, rounds = 1e3 * run["wall"], launches["select_gather"]
    print(f"round slice: K1 (model.apply) share of wall "
          f"{ms['model.apply'] / wall_ms:.4f}, K13+K14 "
          f"{(ms['select_gather'] + ms['select_update']) / wall_ms:.4f}; K1 "
          f"{ms['model.apply'] / rounds / ROUND_LANES:.4f} ms per lane "
          f"evaluation")
    require(run["agree"] >= 0.95, f"round slice agreement {run['agree']} "
                                  f"below the quality gate's 0.95")
    _lanes_vs_serial(ROUND_LANES, "model-r2, round-based, the slice's "
                     "phantom (seed 0)", phantom, seg_serial, run["seg"])

    wide = _run_slice(
        f"{LANES} lanes, model-r2, on kernels", dataclasses.replace(
            settings, concurrent_requests=LANES,
            segmentation_output_dir=os.path.join(tmp, "round64")),
        dev, **phantom, hops=0)
    _lanes_vs_serial(LANES, "model-r2, round-based, the slice's phantom "
                     "(seed 0)", phantom, seg_serial, wide["seg"])
    require(wide["agree"] >= ROUND64_AGREE_FLOOR,
            f"round slice at {LANES} lanes: agreement {wide['agree']} below "
            f"{ROUND64_AGREE_FLOOR}")
    return launches


def _bf16_pair(path, seg_k, seg_p, what="K15 vs its plain version"):
    """Prints how far two bfloat16 slices (by default on K15 and on K15's
    plain version) agree: objects and voxels. They need not be identical:
    float32 sums in another order flip rare bfloat16 roundings, which can
    flip moves."""
    from tools import synthetic_em
    same = synthetic_em.object_level_agreement(seg_k.astype(np.uint64),
                                               seg_p.astype(np.uint64),
                                               min_size=1000)
    print(f"{path}, {what}: object-level agreement "
          f"{same:.4f}, voxels equal {float((seg_k == seg_p).mean()):.6f}, "
          f"identical {bool(np.array_equal(seg_k, seg_p))}")


def phase_bf16_slices(dev, phantom, r2, tmp):
    """bfloat16 inference at full width (model-r2, "dtype": "bfloat16", the
    benches' default) on phase 5's phantom: serial, 8-lane hop, 8-lane round
    and fused slices on K15, the fused one also on K15's plain version on
    one subvolume (the pair's agreement printed). Serial and round held to
    0.95, hop and fused to floors under their measured values. Returns the
    K15 runs' launches (serial_bf16, hop_bf16, round_bf16, fused_bf16) and
    the fused run, which phase 16 compares with."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d

    model_args = json.loads(r2.model_args)
    model_args["dtype"] = "bfloat16"
    bf16 = dataclasses.replace(r2, model_args=json.dumps(model_args))
    launches = {}

    def runs(path, run, floor, seg="seg", plain=None):
        """run(label, out_dir) on K15; then `plain`, if given, with K15's
        plain version patched in."""
        _build.launches.clear()
        got = run("bf16 on K15", os.path.join(tmp, path))
        launches[path] = dict(_build.launches)
        print(f"kernel launches on the {path} path: {launches[path]}")
        require(launches[path].get("conv3d_ndhwc_bf16", 0) > 0 and
                "conv3d_ndhwc_f32" not in launches[path],
                f"the {path} path did not run its convolutions on K15")
        if plain is not None:
            with mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                                   conv3d.conv3d_ndhwc_bf16_plain):
                plain("bf16 on K15's plain version",
                      os.path.join(tmp, path + "_plain"))
        _note(path.split("_")[0], "bfloat16", got, got.get("stitched",
                                                            got.get(seg)))
        require(got["agree"] >= floor, f"{path} slice agreement "
                                       f"{got['agree']} below {floor}")
        return got

    for path, lanes, hops, floor in (
            ("serial_bf16", 1, None, 0.95),
            ("hop_bf16", GATE_LANES, HOPS, BF16_HOP_AGREE_FLOOR),
            ("round_bf16", ROUND_LANES, 0, 0.95)):
        runs(path, lambda label, out: _run_slice(
            f"{lanes} lanes, {label}, model-r2", dataclasses.replace(
                bf16, concurrent_requests=lanes,
                segmentation_output_dir=out), dev, **phantom, hops=hops),
             floor)

    def fused(label, out):
        run = _fused(f"fused slice {label}", os.path.basename(out), tmp,
                     model_args)
        stitch_s, run["stitched"] = _stitch(run["argv"], out + ".npz",
                                            as_process=False)
        run["agree"] = _stitched_agreement(f"fused slice {label}", stitch_s,
                                           run["stitched"], phantom["gt"])
        return run

    def fused_pair(label, out):
        """K15's plain version against K15 on one subvolume."""
        want = _fused(f"fused slice {label}", os.path.basename(out), tmp,
                      model_args, size=FUSED_PAIR_BOX)
        with mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                               conv3d.conv3d_ndhwc_bf16):   # K15 again
            got = _fused("fused slice bf16 on K15", "fused_bf16_pair", tmp,
                         model_args, size=FUSED_PAIR_BOX)
        _bf16_pair("fused_bf16, one subvolume", got["subs"][0][0],
                   want["subs"][0][0])

    return launches, runs("fused_bf16", fused, BF16_FUSED_AGREE_FLOOR,
                          plain=fused_pair)


def phase_bf16_seed_slice(dev, phantom, r2, fused_f32_seeds, tmp):
    """bfloat16 lane seeds (FFN_TPU_SEED_DTYPE=bf16) with model-r2 in bfloat16
    on every path on the *_bf16 seed kernels, with no float32 instantiation
    launched, each against its plain versions, identical: the hop and round
    slices on the whole phantom, the others on a 64^3 corner
    (FUSED_PAIR_BOX). Hop at the JAX e2e bench's configuration (48 lanes,
    hops 16, max_iters 2000; K4-K7); fused
    (K4, K8; against phase 14's float32 seeds) and
    fused with host finalization on the corner alone (K4, K7);
    FFN_TPU_DEVFIN=1 at 8 lanes (K4-K6, K8); round (K13, K14); serial (K2,
    K3). Floors: BF16_SEED_*_FLOOR, 0.95. Returns the launches by path."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import finalize as fin_ops
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    from ffn_tpu_torch.ops import select as select_ops
    from ffn_tpu_torch.ops import step as step_ops

    model_args = json.loads(r2.model_args)
    model_args["dtype"] = "bfloat16"
    settings = dataclasses.replace(r2, model_args=json.dumps(model_args))
    hop_plain = (_plain(hop_ops, "hop_pop", "hop_gather", "hop_update",
                        "hop_screen")
                 + _plain(lane_ops, "lane_verdicts", "lane_mask"))
    seed_bytes = {torch.float32: 4, torch.bfloat16: 2}
    corner, edge = _corner(phantom), FUSED_PAIR_BOX[0]
    launches = {}

    def slice_run(path, lanes, hops, floor, plain, needed, env=(),
                  max_iters=MAX_ITERS, whole=False):
        def run(label, sfx, where):
            with mock.patch.dict(os.environ, dict(
                    env, FFN_TPU_SEED_DTYPE="bf16")):
                torch.cuda.reset_peak_memory_stats()
                out = _run_slice(
                    f"{path}, {lanes} lanes, model-r2 in bf16, bf16 seeds, "
                    f"{label}", dataclasses.replace(
                        settings, concurrent_requests=lanes,
                        segmentation_output_dir=os.path.join(
                            tmp, f"seeds_{path}{sfx}")), dev,
                    **where, hops=hops, max_iters=max_iters)
            out["peak"] = torch.cuda.max_memory_allocated()
            out["seed_bytes"] = (lanes * int(np.prod(where["box"]))
                                 * seed_bytes[out["seed_dtype"]])
            print(f"  seeds {out['seed_dtype']}: {lanes} lanes x "
                  f"{where['box']} = {out['seed_bytes'] / 1e6:.1f} MB; "
                  f"peak device memory {out['peak'] / 1e6:.1f} MB; "
                  f"{out['moves'] / out['wall']:.2f} moves/s")
            torch.cuda.empty_cache()
            return out

        if whole:
            got, launches[path] = _pair(
                f"the bf16-seed {path} slice", lambda label, sfx:
                run(label, sfx, phantom), plain)
        else:
            _build.launches.clear()
            probe = _K8Probe()
            with probe.patch():
                got = run("on kernels", "", phantom)
            launches[path] = dict(_build.launches)
            if probe.events:
                probe.report(f"the bf16-seed {path} slice")
            _pair(f"the bf16-seed {path} slice on {edge}^3",
                  lambda label, sfx: run(f"{edge}^3, {label}", "_pair" + sfx,
                                         corner), plain)
        _check_bf16_launches(path, launches[path], needed)
        require(got["seed_dtype"] == torch.bfloat16 and got["agree"] >= floor,
                f"the bf16-seed {path} slice: seeds {got['seed_dtype']}, "
                f"agreement {got['agree']} below {floor}")
        return got

    slice_run("hop", SEED_LANES, HOPS, BF16_SEED_AGREE_FLOOR, hop_plain,
              ("hop_pop", "hop_gather", "hop_update", "lane_threshold"),
              max_iters=SEED_MAX_ITERS, whole=True)
    slice_run("devfin", GATE_LANES, HOPS, 0.95,
              hop_plain + _plain(fin_ops, "finalize_pass"),
              ("hop_pop", "hop_gather", "hop_update", "finalize_pass"),
              env={"FFN_TPU_DEVFIN": "1"})
    slice_run("round", ROUND_LANES, 0, BF16_SEED_ROUND_AGREE_FLOOR,
              _plain(select_ops, "select_gather", "select_update"),
              ("select_gather", "select_update", "lane_threshold"),
              whole=True)
    slice_run("serial", 1, None, 0.95,
              _plain(step_ops, "step_gather", "step_update"),
              ("step_gather", "step_update"))

    fused = {}
    with mock.patch.dict(os.environ, {"FFN_TPU_SEED_DTYPE": "bf16"}):
        for path, flags, needed in (
                ("fused", [], ("hop_pop", "hop_gather", "hop_update",
                               "finalize_pass")),
                ("fused_host", ["--no-device_finalize"],
                 ("hop_pop", "hop_gather", "hop_update", "lane_threshold",
                  "lane_masks"))):
            if not flags:   # the whole phantom on kernels
                probe = _K8Probe()
                fused[path] = _fused(f"bf16-seed {path} slice on kernels",
                                     f"seeds_{path}", tmp, model_args,
                                     patches=[probe.patch()])
                launches[path] = fused[path]["launches"]
                probe.report(f"the bf16-seed {path} slice")
            got, pair_launches = _pair(
                f"the bf16-seed {path} slice on {edge}^3", lambda label, sfx:
                _fused(f"bf16-seed {path} slice {label}",
                       f"seeds_{path}_pair{sfx}", tmp, model_args, flags,
                       FUSED_PAIR_BOX), _fused_plain(),
                keys=("subs", "moves"))
            fused.setdefault(path, got)
            launches.setdefault(path, pair_launches)
            _check_bf16_launches(path, launches[path], needed)
    run, f32 = fused["fused"], fused_f32_seeds   # f32: phase 14's run
    stitch_s, stitched = _stitch(run["argv"], os.path.join(
        tmp, "seeds_fused.npz"), as_process=False)
    agree = _stitched_agreement("bf16-seed fused slice", stitch_s, stitched,
                                phantom["gt"])
    vox = LANES * FUSED_SUB ** 3   # the lanes' seed voxels
    print(f"bf16-seed fused slice: {run['moves'] / run['wall']:.2f} moves/s "
          f"against {f32['moves'] / f32['wall']:.2f} with float32 seeds; "
          f"lane seed bytes {2 * vox / 1e6:.1f} MB against "
          f"{4 * vox / 1e6:.1f} MB; peak device memory "
          f"{run['peak'] / 1e6:.1f} MB against {f32['peak'] / 1e6:.1f} MB")
    require(agree >= BF16_SEED_FUSED_AGREE_FLOOR,
            f"bf16-seed fused slice agreement {agree} below "
            f"{BF16_SEED_FUSED_AGREE_FLOOR}")
    return {f"{path}_bf16_seeds": p for path, p in launches.items()}


def _check_bf16_launches(path, launches, needed):
    """The bf16-seed kernels `needed` launched on `path` and none of their
    float32 instantiations, but hop_gather's screening gathers (no seeds;
    one per hop_screen)."""
    _require_launched(launches, f"the bf16-seed {path} path",
                      [n + "_bf16" for n in needed] + ["conv3d_ndhwc_bf16"],
                      absent=[n for n in needed if n != "hop_gather"]
                      + ["conv3d_ndhwc_f32"])
    require(launches.get("hop_gather", 0) == launches.get("hop_screen", 0),
            f"the bf16-seed {path} path's float32 K5 launches are not the "
            f"screens'")


def phase_round_golden(dev, r2, tmp):
    """The CI checkpoint at 64 lanes, hops 0, against the JAX package's CPU run
    (gate_ci_lanes_golden.npz's *_round entries): voxels, origins, moves and
    rounds equal."""
    from ffn_tpu_torch.inference import runner as runner_lib
    ref = np.load(os.path.join(REPO, "tests", "golden",
                               "gate_ci_lanes_golden.npz"))
    path = os.path.join(tmp, "round_ci.npy")
    np.save(path, ref["image"])
    ci = dataclasses.replace(
        r2, image=path, concurrent_requests=LANES,
        segmentation_output_dir=os.path.join(tmp, "round_ci"),
        model_checkpoint_path=os.path.join(REPO, "models", "phantom",
                                           "model-ci-tiny.npz"),
        model_args='{"depth": 2, "fov_size": [17, 17, 17], '
                   '"deltas": [6, 6, 6], "features": 16}')
    runner = runner_lib.Runner(device=dev)
    runner.canvas_defaults.update(hops=0, max_iters_per_segment=MAX_ITERS)
    runner.start(ci)
    t0 = time.perf_counter()
    canvas = runner.run((0, 0, 0), ref["image"].shape,
                        keep_probability_maps=False)
    wall = time.perf_counter() - t0
    require(type(canvas).__name__ == "BatchCanvas",
            f"the round golden ran {type(canvas)}")
    seg = np.maximum(canvas.segmentation, 0)
    origins = np.array([(k, *o.start_zyx, o.iters)
                        for k, o in sorted(canvas.origins.items())], np.int64)
    moves = runner.counters["fov-moves"].value
    rounds = runner.counters["predict-calls"].value
    same = (np.array_equal(seg, ref["seg64_round"]),
            np.array_equal(origins, ref["origins64_round"]),
            moves == int(ref["moves64_round"]),
            rounds == int(ref["rounds64_round"]))
    print(f"CI checkpoint, round-based, {LANES} lanes on the gate's phantom: "
          f"{moves} moves in {rounds} rounds, {wall:.3f} s; against the JAX "
          f"package's run ({int(ref['moves64_round'])} moves, "
          f"{int(ref['rounds64_round'])} rounds): identical voxels "
          f"{same[0]}, origins {same[1]}, moves {same[2]}, rounds "
          f"{same[3]}")
    require(all(same), "the CI checkpoint's round-based run differs from "
                       "the JAX package's")


# -- the training path (phases 3 and 11) --------------------------------------

TRAIN_B = 4            # the train CLI's default batch
TRAIN_CANVAS = 49      # 33^3 FOV + 2 * deltas 8
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
TRAIN_COORDS = 512     # foreground centres of the phantom's coordinate file
TRAIN_PLAIN_PARAM_ATOL = 1e-5   # kernel vs plain weights after step 1
# The card against the JAX package's CPU run (tests/make_torch_train_golden:
# lr 0.001, adam's epsilon 1e-3); the port on the CPU lands within 2.4e-7
# of its weights and 1.1e-5 of its losses.
TRAIN_GOLDEN_PARAM_ATOL = 1e-5
TRAIN_GOLDEN_LOSS_RTOL = 1e-4
# Every tensor a (non-zero) step of K11 moves; K12's sgd reads p and g and
# writes p.
TRAIN_K11 = ("train_prep", "train_gather", "train_loss", "train_eval")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_train_kernels(dev):
    """K9-K12 against their plain versions at the training shapes (batch 4,
    33^3 at 32 features, a 49^3 canvas, the depth-12 model's 50 tensors):
    K9, K10 within 1e-4 of max|plain| for every layer kind, each twice bit
    for bit; K11's prep, gather, write-back and counts bit for bit, sums within
    1e-5; K12 within 1e-6 (sgd, adam). Times of kernel, plain and library."""
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import optim as optim_ops
    from ffn_tpu_torch.ops import train as train_ops
    from ffn_tpu_torch.training import optimizer as optimizer_lib

    gen = torch.Generator(device=dev).manual_seed(4)
    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    n, fov = TRAIN_B, (33, 33, 33)
    vox = n * 33 ** 3
    worst = {"conv3d_dgrad_f32": 0.0, "conv3d_wgrad_f32": 0.0}
    for name, (k, cin, cout, pre, post, res) in K1_LAYERS.items():
        x = randn(n, *fov, cin)
        w = randn(k, k, k, cin, cout, scale=(2.0 / (k ** 3 * cin)) ** 0.5)
        dy = randn(n, *fov, cout)
        y = randn(n, *fov, cout) if post else None
        xm = x if pre else None
        # A block's _a layer adds the residual's gradient (accum).
        acc = randn(n, *fov, cin) if pre and post else None
        dx_err = None
        if cin != 2:   # conv0_a takes no input gradient in training
            got = conv3d.conv3d_dgrad_f32(dy, w, x=xm, y=y, accum=acc)
            want = conv3d.conv3d_dgrad_plain(dy, w, x=xm, y=y, accum=acc)
            dx_err = float((got - want).abs().max())
            require(dx_err <= 1e-4 * float(want.abs().max()),
                    f"K9 {name}: error {dx_err}")
            require(torch.equal(conv3d.conv3d_dgrad_f32(
                dy, w, x=xm, y=y, accum=acc), got),
                f"K9 {name}: two runs differ (not deterministic)")
        gw, gb = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
        ww, wb = conv3d.conv3d_wgrad_plain(x, dy, k, pre_relu=pre, y=y)
        dw_err = max(float((gw - ww).abs().max()),
                     float((gb - wb).abs().max()))
        require(dw_err <= 1e-4 * max(float(ww.abs().max()),
                                     float(wb.abs().max())),
                f"K10 {name}: error {dw_err}")
        again = conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y)
        require(torch.equal(again[0], gw) and torch.equal(again[1], gb),
                f"K10 {name}: two runs differ (not deterministic)")
        print(f"K9/K10 N={n} {name}: dgrad max_abs_err {dx_err} wgrad "
              f"max_abs_err {dw_err:.3e}, both deterministic")
        worst["conv3d_dgrad_f32"] = max(worst["conv3d_dgrad_f32"],
                                        dx_err or 0.0)
        worst["conv3d_wgrad_f32"] = max(worst["conv3d_wgrad_f32"], dw_err)
        if name != "32->32 pre+post_relu":
            continue
        # The block's _a layer: 22 of the 25 layers are 32->32.
        flops = 2 * vox * 27 * 32 * 32
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        gc = dy.permute(0, 4, 1, 2, 3).contiguous()
        wc = w.permute(4, 3, 0, 1, 2).contiguous()
        ms, plain_ms, lib_ms = time_many(
            lambda: conv3d.conv3d_dgrad_f32(dy, w, x=xm, y=y, accum=acc),
            lambda: conv3d.conv3d_dgrad_plain(dy, w, x=xm, y=y, accum=acc),
            lambda: torch.nn.grad.conv3d_input(xc.shape, wc, gc, padding=1),
            reps=REPS)
        results["conv3d_dgrad_f32"] = entry(
            dx_err, ms, plain_ms, 4 * (5 * vox * 32 + w.numel()), flops,
            library_ms=lib_ms)
        ms, plain_ms, lib_ms = time_many(
            lambda: conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y),
            lambda: conv3d.conv3d_wgrad_plain(x, dy, k, pre_relu=pre, y=y),
            lambda: torch.nn.grad.conv3d_weight(xc, wc.shape, gc, padding=1),
            reps=REPS)
        results["conv3d_wgrad_f32"] = entry(
            dw_err, ms, plain_ms, 4 * (3 * vox * 32 + w.numel() + 32), flops,
            library_ms=lib_ms)
        # K10 at the host loop's batch of one.
        x1, dy1, y1 = x[:1].clone(), dy[:1].clone(), y[:1].clone()
        xc1, gc1 = xc[:1].clone(), gc[:1].clone()
        ms1 = time_many(
            lambda: conv3d.conv3d_wgrad_f32(x1, dy1, k, pre_relu=pre, y=y1),
            lambda: conv3d.conv3d_wgrad_plain(x1, dy1, k, pre_relu=pre,
                                              y=y1),
            lambda: torch.nn.grad.conv3d_weight(xc1, wc.shape, gc1,
                                                padding=1), reps=REPS)
        bound1 = bound_of(4 * (3 * 33 ** 3 * 32 + w.numel() + 32), flops / n)
        print(f"K10 conv3d_wgrad_f32 {name} B=1: kernel {ms1[0]:.4f} ms "
              f"plain {ms1[1]:.4f} ms library conv3d_weight {ms1[2]:.4f} ms "
              f"bound {bound1[0]:.4f} ms ({bound1[1]})")
        del xc, gc, wc, x1, dy1, y1, xc1, gc1
    for name in ("conv3d_dgrad_f32", "conv3d_wgrad_f32"):
        r = results[name]
        r["max_abs_err"] = worst[name]
        print(f"{name} (32->32, N={n}): kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # K11 on a phantom-like batch: prep, the gather and loss of a shell
    # offset with valid and invalid lanes, and the eval.
    c = TRAIN_CANVAS
    rng = np.random.RandomState(11)
    image_u8 = torch.from_numpy(rng.randint(0, 256, (n, c, c, c, 1)).astype(
        np.uint8)).to(dev)
    lom_u8 = torch.from_numpy((rng.rand(n, c, c, c, 1) > 0.5).astype(
        np.uint8)).to(dev)
    pad, init = float(np.log(0.05 / 0.95)), float(np.log(0.95 / 0.05))
    move_t = float(np.log(0.9 / 0.1))
    prep_args = ((c,) * 3, 128.0, 33.0, 0.05, pad, init)
    got = train_ops.train_prep(image_u8, lom_u8, *prep_args)
    want = train_ops.train_prep_plain(image_u8[..., 0], lom_u8[..., 0],
                                      *prep_args)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "K11 train_prep differs from plain")
    images, labels, _ = want
    seeds = randn(n, c, c, c, scale=3.0)
    off = (8, -8, 0)
    seeds[:2, c // 2 + 8, c // 2 - 8, c // 2] = 5.0
    seeds[2:, c // 2 + 8, c // 2 - 8, c // 2] = -5.0
    gargs = (seeds, images, labels, off, fov, move_t, 0.9)
    kg = train_ops.train_gather(*gargs)
    pg = train_ops.train_gather_plain(*gargs)
    require(all(torch.equal(g, w) for g, w in zip(kg, pg)),
            "K11 train_gather differs from plain")
    ticket = train_ops.new_ticket(dev)
    logits = randn(n, *fov, 1, scale=4.0)
    ks, ps = seeds.clone(), seeds.clone()
    km, pm = torch.zeros(5, device=dev), torch.zeros(5, device=dev)
    kd = train_ops.train_loss(logits, ks, labels, None, kg[2], kg[3], off,
                              km, ticket)
    pd = train_ops.train_loss_plain(logits, ps, labels, None, kg[2], kg[3],
                                    off, pm)
    loss_err = max(_rel_err(kd, pd), _rel_err(km[:1], pm[:1]))
    require(torch.equal(ks, ps) and torch.equal(km[1:], pm[1:]),
            "K11 train_loss: write-back or counts differ from plain")
    require(loss_err <= 1e-5, f"K11 train_loss: error {loss_err}")
    kl, kc = train_ops.train_eval(ks, labels, (c,) * 3, ticket)
    pl, pc = train_ops.train_eval_plain(ks, labels, (c,) * 3)
    eval_err = _rel_err(kl.view(1), pl.view(1))
    require(torch.equal(kc, pc) and eval_err <= 1e-5,
            f"K11 train_eval differs from plain ({eval_err})")
    canvas_b, patch_b = 4 * n * c ** 3, 4 * n * 33 ** 3
    k11 = {
        "train_prep": (0.0, lambda: train_ops.train_prep(image_u8, lom_u8,
                                                         *prep_args),
                       lambda: train_ops.train_prep_plain(
                           image_u8[..., 0], lom_u8[..., 0], *prep_args),
                       2 * n * c ** 3 + 3 * canvas_b),
        "train_gather": (0.0, lambda: train_ops.train_gather(*gargs),
                         lambda: train_ops.train_gather_plain(*gargs),
                         2 * patch_b + 3 * patch_b),
        "train_loss": (loss_err,
                       lambda: train_ops.train_loss(
                           logits, ks, labels, None, kg[2], kg[3], off, km,
                           ticket),
                       lambda: train_ops.train_loss_plain(
                           logits, ps, labels, None, kg[2], kg[3], off, pm),
                       4 * patch_b),
        "train_eval": (eval_err,
                       lambda: train_ops.train_eval(ks, labels, (c,) * 3,
                                                    ticket),
                       lambda: train_ops.train_eval_plain(ks, labels,
                                                          (c,) * 3),
                       2 * canvas_b),
    }
    for name, (err, kfn, pfn, nbytes) in k11.items():
        ms, plain_ms = time_pair(kfn, pfn)
        results[name] = entry(err, ms, plain_ms, nbytes)
        print(f"K11 {name} (B={n}, {c}^3 canvas, 33^3 FOV): max_rel_err "
              f"{err:.3e}, kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{results[name]['bound_ms']:.5f} ms (bytes)")
    results["fov_loss"] = _check_k16(randn, n, fov)

    # K12 on the depth-12 model's parameters with its gradients' scale.
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, features=32)
    shapes = [tuple(p.shape) for p in model.module.parameters()]
    total = sum(int(np.prod(s)) for s in shapes)
    require(total == 638433, f"depth-12 model has {total} parameters")
    ctrl = optim_ops.ctrl_buffer(dev)
    errs = []
    for opt in ("sgd", "adam"):
        h = optimizer_lib.hyper_from_config(
            optimizer_lib.OptimizerConfig(optimizer=opt))
        kp = [randn(*s, scale=0.02) for s in shapes]
        pp = [t.clone() for t in kp]
        slots = 2 if opt == "adam" else 0
        ks1 = [torch.zeros_like(t) for t in kp] if slots else [None] * 50
        ks2 = [torch.zeros_like(t) for t in kp] if slots else [None] * 50
        ps1 = [t.clone() if t is not None else None for t in ks1]
        ps2 = [t.clone() if t is not None else None for t in ks2]
        counts = [torch.zeros((), dtype=torch.int32, device=dev)
                  for _ in range(2)]
        active = torch.tensor(4.0, device=dev)
        kf = torch.zeros((), dtype=torch.bool, device=dev)
        pf = kf.clone()
        for _ in range(3):
            grads = [randn(*s, scale=0.5) for s in shapes]
            optim_ops.optim_update(kp, grads, ks1, ks2, None, h, counts[0],
                                   None, active, kf, ctrl)
            optim_ops.optim_update_plain(pp, grads, ps1, ps2, None, h,
                                         counts[1], None, active, pf)
        errs.append(max(float((a - b).abs().max()) for a, b in zip(
            kp + [t for t in ks1 + ks2 if t is not None],
            pp + [t for t in ps1 + ps2 if t is not None])))
        require(bool(kf) and bool(pf) and errs[-1] <= 1e-6,
                f"K12 {opt}: error {errs[-1]}")
        if opt == "sgd":
            # The host-loop trainer's legacy step: no gate, so a NaN
            # gradient reaches the parameters in both versions.
            up = [t.clone() for t in kp]
            upp = [t.clone() for t in kp]
            nan_grads = [g.clone() for g in grads]
            nan_grads[3].view(-1)[0] = float("nan")
            none = [None] * len(kp)
            zero = torch.zeros((), device=dev)
            optim_ops.optim_update(up, nan_grads, none, none, None, h, None,
                                   None, zero, kf, ctrl, gated=False)
            optim_ops.optim_update_plain(upp, nan_grads, none, none, None, h,
                                         None, None, zero, pf, gated=False)
            require(not bool(kf) and not bool(pf)
                    and bool(torch.isnan(up[3]).view(-1)[0])
                    and all(torch.allclose(a, b, rtol=0, atol=1e-6,
                                           equal_nan=True)
                            for a, b in zip(up, upp)),
                    "K12 ungated (legacy) step differs from plain")
            print("K12 ungated (make_fov_train_step's legacy form): a NaN "
                  "gradient entry reaches its parameter, equal to plain")
            ms, plain_ms = time_pair(
                lambda: optim_ops.optim_update(kp, grads, ks1, ks2, None, h,
                                               counts[0], None, active, kf,
                                               ctrl),
                lambda: optim_ops.optim_update_plain(
                    pp, grads, ps1, ps2, None, h, counts[1], None, active,
                    pf))
            sgd_ms = (ms, plain_ms)
    results["optim_update"] = entry(max(errs), *sgd_ms, 3 * 4 * total)
    r = results["optim_update"]
    print(f"K12 optim_update (50 tensors, {total} parameters, sgd): "
          f"max_abs_err {max(errs):.3e} (sgd, adam), kernel {r['ms']:.4f} "
          f"ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
          f"(bytes); no single torch.optim call has the clip and gate")
    return results


def _check_k16(randn, n, fov):
    """K16 at the host-loop step's shapes (x = 0 and +-30 among the logits,
    zero weights): dlogits within 1e-6 of max|plain|, loss 1e-5 relative,
    twice bit for bit, NaN where plain has it; timed beside
    binary_cross_entropy_with_logits and its autograd."""
    import torch.nn.functional as F
    from ffn_tpu_torch.ops import train as train_ops
    x = randn(n, *fov, 1, scale=4.0)
    x.view(-1)[:3] = torch.tensor([0.0, 30.0, -30.0], device=x.device)
    y = torch.where(randn(n, *fov, 1) > 0, 0.95, 0.05)
    w = randn(n, *fov, 1).abs()
    w[w < 0.25] = 0.0
    ticket = train_ops.new_ticket(x.device)
    kd, kl = train_ops.fov_loss(x, y, w, ticket)
    pd, pl = train_ops.fov_loss_plain(x, y, w)
    again = train_ops.fov_loss(x, y, w, ticket)
    require(torch.equal(again[0], kd) and torch.equal(again[1], kl),
            "K16 fov_loss: two runs differ (not deterministic)")
    d_err, l_err = _rel_err(kd, pd), _rel_err(kl.view(1), pl.view(1))
    require(d_err <= 1e-6 and l_err <= 1e-5,
            f"K16 fov_loss: dlogits error {d_err}, loss error {l_err}")
    err = max(float((kd - pd).abs().max()), float((kl - pl).abs()))
    xn = x.clone()
    xn.view(-1)[7] = float("nan")
    nd, nl = train_ops.fov_loss(xn, y, w, ticket)
    npd, npl = train_ops.fov_loss_plain(xn, y, w)
    require(bool(torch.isnan(nl)) and bool(torch.isnan(npl))
            and torch.equal(torch.isnan(nd), torch.isnan(npd)),
            "K16 fov_loss: NaN propagation differs from plain")
    xl = x.clone().requires_grad_()

    def library():
        return torch.autograd.grad(
            F.binary_cross_entropy_with_logits(xl, y, weight=w), xl)

    ms, plain_ms, lib_ms = time_many(
        lambda: train_ops.fov_loss(x, y, w, ticket),
        lambda: train_ops.fov_loss_plain(x, y, w), library)
    # Bytes: logits, labels and weights read, dlogits and the loss written.
    r = entry(err, ms, plain_ms, 16 * x.numel() + 4, library_ms=lib_ms)
    print(f"K16 fov_loss (B={n}, 33^3): dlogits max_rel_err {d_err:.3e}, "
          f"loss {l_err:.3e}, max_abs_err {err:.3e}; kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library {lib_ms:.4f} ms bound "
          f"{r['bound_ms']:.5f} ms (bytes)")
    return r


class _StepRecorder:
    """Wraps the packed step: keeps each step's metrics (device tensors),
    the weights after step 1 (a device copy) and a CUDA event at the end of
    each step, with no host read during the run."""

    def __init__(self):
        self.metrics, self.events, self.params1 = [], [], None

    def make(self, make_step):
        def make_recorded(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def run(state, *a):
                state, metrics = step(state, *a)
                self.metrics.append(metrics)
                if self.params1 is None:
                    self.params1 = {n: p.detach().clone()
                                    for n, p in state.params.items()}
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
                return state, metrics
            return run
        return make_recorded


def _dgrad_kind(dy, weight, x=None, y=None, accum=None):
    """An input-gradient call's layer kind: its kernel size, widths and the
    masks and cotangent it takes."""
    k, cin, cout = weight.shape[0], weight.shape[3], weight.shape[4]
    took = [f for f, t in (("x", x), ("y", y), ("accum", accum))
            if t is not None]
    return f"{k}^3 {cin}->{cout}" + (" " + "+".join(took) if took else "")


class _KernelProbe:
    """Time of each training kernel: CUDA events around every launch of
    each wrapper (device time only while the queue stays full: where it
    runs dry, a pair also spans the host's gap), and the host's time inside
    each wrapper (perf_counter). Used on runs whose numbers are held bit
    for bit against an unprobed run's, or not held at all."""

    def __init__(self, train_kernels=TRAIN_K11, extra=False):
        from ffn_tpu_torch.ops import conv3d
        from ffn_tpu_torch.ops import optim as optim_ops
        from ffn_tpu_torch.ops import train as train_ops
        self.targets = [(conv3d, n) for n in (
            ("conv3d_ndhwc_bf16", "conv3d_dgrad_16", "conv3d_wgrad_16")
            if extra else ("conv3d_ndhwc_f32", "conv3d_dgrad_f32",
                           "conv3d_wgrad_f32"))]
        self.targets += [(train_ops, n) for n in train_kernels]
        self.targets += [(optim_ops, "optim_update")]
        self.pairs = {n: [] for _, n in self.targets}
        self.host = {n: 0.0 for _, n in self.targets}
        self.dgrad_kinds = collections.Counter()
        self.patches = []

    def _wrap(self, name, fn):
        def probed(*args, **kwargs):
            if name.startswith("conv3d_dgrad"):
                self.dgrad_kinds[_dgrad_kind(*args, **kwargs)] += 1
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs[name].append((start, end))
            self.host[name] += time.perf_counter() - t0
            return out
        return probed

    def __enter__(self):
        for module, name in self.targets:
            p = mock.patch.object(module, name,
                                  self._wrap(name, getattr(module, name)))
            p.start()
            self.patches.append(p)
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in pairs)
                for n, pairs in self.pairs.items()}


def _train_data(tmp):
    """The seed-0 phantom as .npy image and labels, and a coordinate file
    of foreground centres whose 49^3 box fits (a seeded RandomState)."""
    from tools import synthetic_em
    image, gt = synthetic_em.make_volume(size=PHANTOM_SIZE, seed=0,
                                         num_cells=PHANTOM_CELLS)
    np.save(os.path.join(tmp, "train_img.npy"), image)
    np.save(os.path.join(tmp, "train_lab.npy"), gt)
    half = TRAIN_CANVAS // 2
    inner = gt[half:-half, half:-half, half:-half]
    fg = np.argwhere(inner > 0) + half
    rng = np.random.RandomState(0)
    zyx = fg[rng.choice(len(fg), TRAIN_COORDS, replace=False)]
    np.savez_compressed(os.path.join(tmp, "train_coords.npz"),
                        center=zyx[:, ::-1].astype(np.int64),
                        label_volume_name=np.array(["p"] * TRAIN_COORDS))
    print(f"training data: the seed-0 phantom ({PHANTOM_SIZE}^3, "
          f"{PHANTOM_CELLS} cells) as .npy, {TRAIN_COORDS} foreground "
          f"centres whose {TRAIN_CANVAS}^3 box fits")
    return image, gt


def _train_argv(tmp, train_dir):
    return ["--train_coords", os.path.join(tmp, "train_coords.npz"),
            "--data_volumes", "p:" + os.path.join(tmp, "train_img.npy"),
            "--label_volumes", "p:" + os.path.join(tmp, "train_lab.npy"),
            "--image_mean", "128", "--image_stddev", "33",
            "--train_dir", train_dir, "--max_steps", str(TRAIN_STEPS),
            "--checkpoint_every_steps", str(TRAIN_CKPT_EVERY),
            "--summary_every_steps", str(TRAIN_CKPT_EVERY),
            "--device", "cuda"]


def _train_run(label, argv, probe=None):
    """One CLI run in this process; returns (recorder, wall s)."""
    from ffn_tpu_torch.cli import train as train_cli
    from ffn_tpu_torch.training import train_lib, train_loop
    rec = _StepRecorder()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(train_loop.train_lib,
                           "make_scan_train_step_packed",
                           rec.make(train_lib.make_scan_train_step_packed)):
        train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(rec.metrics)
    require(steps > 0, f"{label}: no step ran")
    # Steady rate: device time between the ends of the second and the
    # last step (the first steps pay allocation and the kernels' loading).
    steady = rec.events[1].elapsed_time(rec.events[-1]) / 1e3 \
        if steps > 2 else float("nan")
    rate = (steps - 2) / steady if steps > 2 else float("nan")
    curve = [float(m["loss"][m["active"] > 0].mean()) for m in rec.metrics]
    for m in rec.metrics:
        require(all(bool(torch.isfinite(m[k]).all()) for k in
                    ("loss", "patch_loss")), f"{label}: non-finite loss")
    print(f"train {label}: {steps} steps in {wall:.3f} s wall; steady "
          f"{rate:.4f} steps/s (steps 3-{steps}), "
          f"{rate * 27 * TRAIN_B:.2f} FOV forward+backward/s; mean loss of "
          f"the active offsets per step {['%.5f' % v for v in curve]}")
    return rec, wall


def _ckpt_arrays(train_dir, step):
    out = {}
    for prefix in ("model", "opt"):
        with np.load(os.path.join(train_dir, "ckpt",
                                  f"{prefix}.ckpt-{step}.npz")) as f:
            out.update({f"{prefix}/{k}": f[k] for k in f.files})
    return out


def _train_plain_patches():
    """K1, K9-K12 and K16 on their plain versions: autograd of cuDNN's
    convolution and torch ops for the step's passes and the optimizer."""
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import optim as optim_ops
    from ffn_tpu_torch.ops import train as train_ops
    return [
        mock.patch.object(convstack_3d, "conv3d_train",
                          conv3d.conv3d_ndhwc_plain),
        mock.patch.object(convstack_3d, "residual_block_train",
                          conv3d.residual_block_plain),
        mock.patch.object(train_ops, "train_prep",
                          lambda img, lom, *a: train_ops.train_prep_plain(
                              img[..., 0], lom[..., 0], *a)),
        mock.patch.object(train_ops, "train_gather",
                          lambda s, i, lab, off, fov, mt, lt, window=None:
                          train_ops.train_gather_plain(
                              s, i, lab, tuple(off), tuple(fov), mt, lt,
                              window)),
        mock.patch.object(train_ops, "train_loss",
                          lambda *a, scale=None: train_ops.train_loss_plain(
                              *a[:8], scale=scale)),
        mock.patch.object(train_ops, "train_eval",
                          lambda s, lab, ev, ws: train_ops.train_eval_plain(
                              s, lab, tuple(ev))),
        mock.patch.object(train_ops, "fov_loss",
                          lambda lg, lab, w, ticket, scale=None:
                          train_ops.fov_loss_plain(lg, lab, w, scale)),
        mock.patch.object(optim_ops, "optim_update",
                          lambda *a, **k: optim_ops.optim_update_plain(
                              *a[:10], **k)),
    ]


def phase_train(dev, tmp):
    """The train CLI at its defaults (depth 12, 32 features, 33^3, deltas 8,
    batch 4, 27 offsets, sgd 0.001, float32) for 8 steps on the seed-0
    phantom, checkpoints every 4; 2 steps on plain versions (step 1: losses
    1e-4 relative, counts equal, weights 1e-5); a run resumed from step 4
    (step 8 bit for bit; kernels timed by CUDA events); one profiled step;
    the CI model against tests/golden/train_ci_golden.npz; the trained
    checkpoint in the serial Runner. Returns the kernel run's launches."""
    import shutil
    from ffn_tpu_torch import _build

    _train_data(tmp)
    kdir = os.path.join(tmp, "train_kernels")
    _build.launches.clear()
    krec, kwall = _train_run("on kernels", _train_argv(tmp, kdir))
    launches = dict(_build.launches)
    print(f"kernel launches on the training path: {launches}")
    for name in ("conv3d_ndhwc_f32", "conv3d_dgrad_f32", "conv3d_wgrad_f32",
                 "optim_update") + TRAIN_K11:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the training path")
    ks = sorted(os.listdir(os.path.join(kdir, "ckpt")))
    require(ks == sorted(f"{p}.ckpt-{s}.npz" for p in ("extra", "model",
                                                       "opt")
                         for s in (4, 8)), f"checkpoints: {ks}")

    pdir = os.path.join(tmp, "train_plain")
    patches = _train_plain_patches()
    for p in patches:
        p.start()
    try:
        argv = _train_argv(tmp, pdir)
        argv[argv.index("--max_steps") + 1] = "2"   # step 1 is compared
        prec, pwall = _train_run("on plain versions (cuDNN autograd)", argv)
    finally:
        for p in patches:
            p.stop()
    km, pm = krec.metrics[0], prec.metrics[0]
    for k in ("active", "correct", "missed", "spurious"):
        require(torch.equal(km[k], pm[k]),
                f"train step 1 {k}: kernels {km[k].tolist()} plain "
                f"{pm[k].tolist()}")
    loss_err = float(((km["loss"] - pm["loss"]).abs()
                      / pm["loss"].abs().clamp(min=1e-30)).max())
    param_err = max(float((krec.params1[n] - prec.params1[n]).abs().max())
                    for n in krec.params1)
    print(f"train step 1, kernels vs plain: counts equal, per-offset loss "
          f"max relative error {loss_err:.3e} (bound 1e-4), weights max "
          f"abs error {param_err:.3e} (bound {TRAIN_PLAIN_PARAM_ATOL})")
    require(loss_err <= 1e-4, f"train step 1 loss: {loss_err}")
    require(param_err <= TRAIN_PLAIN_PARAM_ATOL,
            f"train step 1 weights: {param_err}")

    rdir = os.path.join(tmp, "train_resumed")
    os.makedirs(os.path.join(rdir, "ckpt"))
    for p in ("model", "opt", "extra"):
        shutil.copy(os.path.join(kdir, "ckpt", f"{p}.ckpt-{TRAIN_CKPT_EVERY}"
                                 ".npz"), os.path.join(rdir, "ckpt"))
    with _KernelProbe() as probe:
        rrec, _ = _train_run(f"resumed at step {TRAIN_CKPT_EVERY}, "
                                 f"probed", _train_argv(tmp, rdir))
    device_ms = probe.ms()
    a = _ckpt_arrays(kdir, TRAIN_STEPS)
    b = _ckpt_arrays(rdir, TRAIN_STEPS)
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    print(f"resume from step {TRAIN_CKPT_EVERY} to {TRAIN_STEPS}: "
          f"model.ckpt-{TRAIN_STEPS} and opt.ckpt-{TRAIN_STEPS} bit for bit "
          f"{same}")
    require(same, "the resumed run differs from the uninterrupted one")
    busy = sum(device_ms.values())
    steps = len(rrec.metrics)
    steady_ms = krec.events[1].elapsed_time(krec.events[-1]) / (
        len(krec.metrics) - 2)
    print(f"resumed run, device ms over {steps} steps: " + ", ".join(
        f"{n} {v:.1f}" for n, v in device_ms.items())
          + f"; {busy / steps:.1f} ms a step against the steady "
          f"{steady_ms:.1f}: busy {busy / steps / steady_ms:.4f}")

    print(f"K9 conv3d_dgrad_f32 launches a step by layer kind: " + ", ".join(
        f"{k} {v / steps:g}" for k, v in sorted(probe.dgrad_kinds.items())))
    _train_profile(dev)
    _train_golden(dev)
    _train_inference(dev, tmp, kdir)
    return launches


# -- reduced-precision training (phases 3 and 17) ----------------------------

LOWP = {"bf16": torch.bfloat16, "f16": torch.float16}
LOWP_STEPS = 8
LOWP_HOST_STEPS = 12
# Step 1 on kernels against plain versions: the per-offset losses and the
# weights (sgd, lr 0.001) after the 27 offsets (a 16-bit sum that rounds
# the other way moves an output by one ulp of its type); measured on the
# H100: losses equal, weights 1.5e-8 (bf16) and 3.8e-9 (f16).
LOWP_LOSS_RTOL, LOWP_PARAM_ATOL = 1e-4, 1e-6
# K18 launches a 16-bit step (27 offsets): the 24 3^3 layers on the
# tensor-core body, conv_lom on the CUDA-core one; the device ms a step K18
# took with every layer on K10's CUDA-core body (PERF.md §5; NVIDIA H100
# 80GB HBM3, 700 W).
LOWP_K18_TC, LOWP_K18_CORE = 27 * 24, 27
LOWP_K18_CORE_MS = {"bf16": 925.3, "f16": 906.4}
LOWP_PROFILE_STEPS = 3
# Largest share of K17's outputs that may differ from its plain version:
# its float32 order is not the plain one's, and float16's finer ulp meets
# more rounding points (measured on the H100: 1.8e-4 bf16, 1.8e-3 f16).
K17_DIFFER_SHARE = {torch.bfloat16: 1e-3, torch.float16: 5e-3}


def _lowp_profile(dev, prec):
    """One steady step of the 16-bit trainer at the train CLI's defaults
    (after two warm-up steps): the wall of LOWP_PROFILE_STEPS steps between
    two synchronizations, with the host's ms inside each wrapper
    (_KernelProbe), then one step under torch.profiler for each kernel's
    device ms. Prints ms a step."""
    from torch.profiler import ProfilerActivity, profile
    from ffn_tpu_torch.training import train_lib, train_loop
    torch.manual_seed(0)
    config = train_lib.TrainConfig(batch_size=TRAIN_B, precision=prec)
    model = train_loop.build_model("convstack_3d.ConvStack3DFFNModel", "",
                                   config)
    model.module.to(dev)
    state, opt = train_lib.create_train_state(model, config)
    step = train_lib.make_scan_train_step_packed(model, opt, config)
    rng = np.random.RandomState(0)
    shape = (TRAIN_B,) + (TRAIN_CANVAS,) * 3 + (1,)
    image = torch.from_numpy(rng.randint(0, 256, shape).astype(
        np.uint8)).to(dev)
    lom = torch.from_numpy((rng.rand(*shape) > 0.5).astype(np.uint8)).to(dev)
    offsets = train_lib.fixed_offsets_zyx(model.info)
    for _ in range(2):
        state, _ = step(state, image, lom, offsets)
    torch.cuda.synchronize()
    with _KernelProbe(extra=True) as probe:
        t0 = time.perf_counter()
        for _ in range(LOWP_PROFILE_STEPS):
            state, _ = step(state, image, lom, offsets)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / LOWP_PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, image, lom, offsets)
        torch.cuda.synchronize()
    by = {}   # device activity by kernel name, template arguments cut
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.device_time_total > 0:
            name = e.key[len("void "):] if e.key.startswith("void ") \
                else e.key
            name = name.replace("(anonymous namespace)::", "").split(
                "(")[0].split("<")[0]
            count, us = by.get(name, (0, 0.0))
            by[name] = (count + e.count, us + e.device_time_total)
    kernels = sorted(((n, c, us) for n, (c, us) in by.items()),
                     key=lambda r: -r[2])
    device = sum(us for _, _, us in kernels) / 1e3
    k18 = sum(us for name, _, us in kernels if "wgrad" in name) / 1e3
    host = {k: 1e3 * v / LOWP_PROFILE_STEPS for k, v in probe.host.items()}
    print(f"train {prec}, one steady step: {wall:.1f} ms wall (steps 3-"
          f"{2 + LOWP_PROFILE_STEPS}, synchronized), {device:.1f} device ms "
          f"(torch.profiler, step {3 + LOWP_PROFILE_STEPS}): busy "
          f"{device / wall:.4f}; host ms inside the wrappers: " + ", ".join(
              f"{k} {v:.1f}" for k, v in host.items())
          + f"; the rest of the host (autograd, torch ops, the step's "
          f"Python) {wall - sum(host.values()):.1f}")
    for name, count, us in kernels[:8]:
        print(f"  {us / 1e3:10.4f} ms {count:5d}x {name}")
    calls = sorted(((e.key, e.count, e.self_cpu_time_total)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda r: -r[2])
    print(f"train {prec}, the host's largest self times in that step "
          f"(torch.profiler, which adds its own): " + ", ".join(
              f"{k} {us / 1e3:.1f} ms {n}x" for k, n, us in calls[:8]))
    print(f"K18 conv3d_wgrad_16, {prec}: {k18:.1f} device ms a steady step "
          f"(torch.profiler; all layers on K10's CUDA-core body: "
          f"{LOWP_K18_CORE_MS[prec]})")


def _lowp_plain_patches():
    """K15, K17 and K18 on their plain versions (the 16-bit autograd
    Functions look them up in ops.conv3d at each call)."""
    from ffn_tpu_torch.ops import conv3d
    return [mock.patch.object(conv3d, name, getattr(conv3d, name + "_plain"))
            for name in ("conv3d_ndhwc_bf16", "conv3d_dgrad_16",
                         "conv3d_wgrad_16")]


def phase_lowp_kernels(dev):
    """K15 in float16 per layer kind at N = 1, 4, 64 against plain
    (k15_tolerance, DIFFER_SHARE) and the float64 sums (bit for bit), a
    repeat, sample 17 alone, block_a timed at N = 4 and 64; K17 and K18 in
    bfloat16 and float16 at batch 4 against plain, each repeat bit for bit:
    K17 (a block's first layer with masks and the residual's cotangent,
    32->32) within one ulp per rounding plus 2^-20 of the sum of |w||g|, at
    most K17_DIFFER_SHARE differing, conv_lom bit for bit; K18 (32->32 with
    and without masks, 2->32 float32 x and 32->32 at N=1 on the tensor
    cores, 32->1 float32 dy on the CUDA cores) within one ulp plus 2^-16 of
    the sum of |x||g|, each on the body wgrad16_route names; K12 with a
    DynamicLossScale (50 tensors, gradients x2^15: finite, inf, NaN) and
    K16 with the scale bit for bit. Times beside cuDNN's and bounds (K18 at
    each layer kind a step launches, and launches x time a step)."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import conv3d_bf16_check as check
    from ffn_tpu_torch.ops import optim as optim_ops
    from ffn_tpu_torch.ops import train as train_ops
    from ffn_tpu_torch.training import optimizer as optimizer_lib
    from ffn_tpu_torch.training import precision as precision_lib

    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = _k15_layers(gen, torch.float16, (1, TRAIN_B, LANES),
                          {TRAIN_B: ("block_a",), LANES: ("block_a",)},
                          TRAIN_B)

    n, fov = TRAIN_B, (33, 33, 33)
    vox, flops = n * 33 ** 3, 2 * TRAIN_B * 33 ** 3 * 27 * 32 * 32
    for dt in LOWP.values():
        sfx = conv3d.SUFFIX[dt]

        def ulp(t):
            return check.bf16_ulp(t, dt)
        x, a = randn(n, *fov, 32).to(dt), randn(n, *fov, 32).to(dt)
        dy, acc = (randn(n, *fov, 32, scale=0.01).to(dt) for _ in "da")
        w = randn(3, 3, 3, 32, 32, scale=(2 / 864) ** 0.5).to(dt)
        derr = werr = 0.0
        for case, kw in (("block_a", dict(x=x, y=a, accum=acc)),
                         ("32->32", {})):
            got = conv3d.conv3d_dgrad_16(dy, w, **kw)
            want = conv3d.conv3d_dgrad_16_plain(dy, w, **kw)
            tol = check.k17_tolerance(dy, w, want, **kw)
            delta = (got.float() - want.float()).abs()
            worst = float((delta / tol).max())
            differ = float((delta > 0).float().mean())
            derr = max(derr, float(delta.max()))
            print(f"K17 conv3d_dgrad_{sfx} B={n} {case}: {differ:.3e} of "
                  f"outputs differ from plain, max {worst:.3f} of the "
                  f"tolerance")
            require(worst <= 1.0 and differ <= K17_DIFFER_SHARE[dt] and
                    torch.equal(got, conv3d.conv3d_dgrad_16(dy, w, **kw)),
                    f"K17 {sfx} {case} against plain")
        lom_dy = randn(n, *fov, 1, scale=2.0 ** 15 / vox)
        lom_w = randn(1, 1, 1, 32, 1, scale=0.2).to(dt)
        require(torch.equal(conv3d.conv3d_dgrad_16(lom_dy, lom_w, x=x),
                            conv3d.conv3d_dgrad_16_plain(lom_dy, lom_w,
                                                         x=x)),
                f"K17 {sfx} conv_lom differs from plain")
        x0 = randn(n, *fov, 2)
        werr = {"conv3d_wgrad_" + sfx: 0.0, "conv3d_wgrad1_" + sfx: 0.0}
        for case, args, kw in (
                ("32->32 pre_relu, mask", (x, dy, 3), dict(pre_relu=True,
                                                            y=a)),
                ("32->32", (a, dy, 3), {}),
                ("2->32 float32 x, mask", (x0, dy, 3), dict(y=a)),
                ("32->1 k=1 float32 dy", (x, lom_dy, 1),
                 dict(pre_relu=True)),
                ("32->32 pre_relu, mask, N=1", (x[:1], dy[:1], 3),
                 dict(pre_relu=True, y=a[:1]))):
            _build.launches.clear()
            got = conv3d.conv3d_wgrad_16(*args, **kw)
            body = next(iter(_build.launches))
            want = conv3d.conv3d_wgrad_16_plain(*args, **kw)
            mag = conv3d.conv3d_wgrad_plain(
                *(t.to(dt).float().abs() for t in args[:2]), args[2],
                y=kw["y"].float() if "y" in kw else None)
            worst = max(float(((g - p).abs() / (ulp(p) + m * 2.0 ** -16))
                              .max()) for g, p, m in zip(got, want, mag))
            werr[body] = max([werr[body]] + [float((g - p).abs().max())
                                             for g, p in zip(got, want)])
            again = conv3d.conv3d_wgrad_16(*args, **kw)
            print(f"K18 {body} B={args[0].shape[0]} {case}: max "
                  f"{worst:.3f} of the tolerance")
            require(worst <= 1.0 and all(torch.equal(g, h) for g, h in zip(
                again, got)) and body == ("conv3d_wgrad1_" if args[2] == 1
                                          else "conv3d_wgrad_") + sfx,
                    f"K18 {sfx} {case}")
        xc, gc, wc, x0c, lomc = (t.permute(*p).contiguous() for t, p in (
            (x, (0, 4, 1, 2, 3)), (dy, (0, 4, 1, 2, 3)),
            (w, (4, 3, 0, 1, 2)), (x0.to(dt), (0, 4, 1, 2, 3)),
            (lom_dy.to(dt), (0, 4, 1, 2, 3))))
        kw = dict(x=x, y=a, accum=acc)
        lom_bytes = 2 * vox * 32 + 4 * vox + 4 * 33
        k18 = {}
        for name, what, e, fns, nbytes, ops in (
                ("conv3d_dgrad_" + sfx, "32->32", derr, (
                    lambda: conv3d.conv3d_dgrad_16(dy, w, **kw),
                    lambda: conv3d.conv3d_dgrad_16_plain(dy, w, **kw),
                    lambda: torch.nn.grad.conv3d_input(xc.shape, wc, gc,
                                                       padding=1)),
                 2 * (5 * vox * 32 + 27 * 1024), flops),
                ("conv3d_wgrad_" + sfx, "32->32 pre_relu, mask",
                 werr["conv3d_wgrad_" + sfx], (
                     lambda: conv3d.conv3d_wgrad_16(x, dy, 3, pre_relu=True,
                                                    y=a),
                     lambda: conv3d.conv3d_wgrad_16_plain(
                         x, dy, 3, pre_relu=True, y=a),
                     lambda: torch.nn.grad.conv3d_weight(xc, wc.shape, gc,
                                                         padding=1)),
                 2 * 3 * vox * 32 + 4 * (27 * 1024 + 32), flops),
                ("conv3d_wgrad_" + sfx + "@conv0_a", "2->32 float32 x, mask",
                 werr["conv3d_wgrad_" + sfx], (
                     lambda: conv3d.conv3d_wgrad_16(x0, dy, 3, y=a),
                     lambda: conv3d.conv3d_wgrad_16_plain(x0, dy, 3, y=a),
                     lambda: torch.nn.grad.conv3d_weight(
                         x0c, (32, 2, 3, 3, 3), gc, padding=1)),
                 4 * vox * 2 + 2 * 2 * vox * 32 + 4 * (27 * 64 + 32),
                 flops / 16),
                ("conv3d_wgrad1_" + sfx, "32->1 k=1 float32 dy",
                 werr["conv3d_wgrad1_" + sfx], (
                     lambda: conv3d.conv3d_wgrad_16(x, lom_dy, 1,
                                                    pre_relu=True),
                     lambda: conv3d.conv3d_wgrad_16_plain(x, lom_dy, 1,
                                                          pre_relu=True),
                     lambda: torch.nn.grad.conv3d_weight(
                         xc, (1, 32, 1, 1, 1), lomc)),
                 lom_bytes, 2 * vox * 32)):
            ms, plain_ms, lib_ms = time_many(*fns, reps=10)
            r = results[name] = entry(e, ms, plain_ms, nbytes, ops,
                                      library_ms=lib_ms, peak=BF16_FLOPS)
            k18[name] = ms
            print(f"{name} ({what}, B={n}): kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms library (cuDNN {sfx}) {lib_ms:.4f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results.pop("conv3d_wgrad_" + sfx + "@conv0_a")
        # A step: 27 offsets, each conv0_a, 23 32->32 layers and conv_lom.
        step = 27 * (k18["conv3d_wgrad_" + sfx + "@conv0_a"]
                     + 23 * k18["conv3d_wgrad_" + sfx]
                     + k18["conv3d_wgrad1_" + sfx])
        print(f"K18 {sfx}: launches x time = {step:.1f} ms a step "
              f"predicted (27 x (conv0_a + 23 x 32->32 + conv_lom))")
        del x, a, dy, acc, xc, gc, wc, x0, x0c, lomc
        torch.cuda.empty_cache()

    # K12 with the loss scale; the scale in K16.
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, features=32)
    shapes = [tuple(p.shape) for p in model.module.parameters()]
    h = optimizer_lib.hyper_from_config(optimizer_lib.OptimizerConfig())
    ctrl = optim_ops.ctrl_buffer(dev)
    none, active = [None] * len(shapes), torch.tensor(4.0, device=dev)
    flags = [torch.zeros((), dtype=torch.bool, device=dev) for _ in "kp"]
    for bad in (None, float("inf"), float("nan")):
        kp = [randn(*s, scale=0.02) for s in shapes]
        pp = [t.clone() for t in kp]
        scales = [precision_lib.DynamicLossScale.init(
            2.0 ** 15, growth_interval=2, device=dev) for _ in "kp"]
        for step in range(3):
            grads = [randn(*s, scale=0.5 * 2.0 ** 15) for s in shapes]
            if bad is not None and step == 1:
                grads[7].view(-1)[5] = bad
            optim_ops.optim_update(kp, grads, none, none, None, h, None,
                                   None, active, flags[0], ctrl,
                                   loss_scale=scales[0])
            optim_ops.optim_update_plain(pp, grads, none, none, None, h,
                                         None, None, active, flags[1],
                                         loss_scale=scales[1])
            require(all(torch.equal(a, b) for a, b in zip(kp, pp)) and
                    torch.equal(flags[0], flags[1]) and all(torch.equal(
                        getattr(scales[0], f), getattr(scales[1], f))
                        for f in ("scale", "counter")),
                    f"K12 with the scale ({bad}) step {step} differs")
        print(f"K12 with a DynamicLossScale, gradients x2^15 ({bad}): "
              f"parameters, scale {float(scales[0].scale)}, counter "
              f"{int(scales[0].counter)}, flag equal to plain bit for bit")
    scale = precision_lib.DynamicLossScale.init(device=dev)
    ms, plain_ms = time_pair(*(
        lambda f=f, p=p, c=c: f(p, grads, none, none, None, h, None, None,
                                active, flags[0], *c, loss_scale=scale)
        for f, p, c in ((optim_ops.optim_update, kp, (ctrl,)),
                        (optim_ops.optim_update_plain, pp, ()))))
    total = sum(int(np.prod(s)) for s in shapes)
    results["optim_update_scaled"] = entry(0.0, ms, plain_ms, 3 * 4 * total)
    print(f"K12 optim_update_scaled (50 tensors, sgd): kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms")
    lg = randn(n, *fov, 1, scale=4.0)
    lab = (randn(n, *fov, 1) > 0).float() * 0.9 + 0.05
    wt = torch.rand(n, *fov, 1, generator=gen, device=dev)
    s15, ticket = torch.tensor(2.0 ** 15, device=dev), \
        train_ops.new_ticket(dev)
    d1, l1 = train_ops.fov_loss(lg, lab, wt, ticket)
    d2, l2 = train_ops.fov_loss(lg, lab, wt, ticket, scale=s15)
    require(torch.equal(d1 * s15, d2) and torch.equal(l1, l2),
            "K16 with the scale differs from scale x unscaled")
    print("K16 fov_loss with the loss scale 2^15: scale x the unscaled "
          "gradient bit for bit")
    return results


def _lowp_run(prec, tmp, out, steps, probe=None):
    argv = _train_argv(tmp, out) + ["--precision", prec]
    argv[argv.index("--max_steps") + 1] = str(steps)
    if probe is None:
        return _train_run(f"{prec}, {os.path.basename(out)}", argv)
    with probe:
        return _train_run(f"{prec}, {os.path.basename(out)}, probed", argv)


def phase_train_lowp(dev, tmp):
    """The train CLI at full width (phase 11's run) with --precision bf16 and
    f16, 8 steps each on K15/K17/K18, K11 and K12 (f16: optim_update_scaled),
    kernels timed by CUDA events, then one steady step of each profiled
    (_lowp_profile: wall, device ms by kernel, host ms); 2 steps on plain
    versions (step 1 within
    LOWP_LOSS_RTOL and LOWP_PARAM_ATOL, the scale equal); f16 resumed from
    step 4 (step 8 with its scale bit for bit); the host-loop trainer in bf16
    for LOWP_HOST_STEPS. Returns the launches (train_bf16, train_f16,
    train_host_bf16)."""
    import shutil
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.cli import train as train_cli
    from ffn_tpu_torch.training import train_lib, train_loop

    launches = {}
    for prec, dt in LOWP.items():
        sfx = prec
        kdir = os.path.join(tmp, f"train_{prec}")
        _build.launches.clear()
        probe = _KernelProbe(extra=True) if prec == "bf16" else None
        krec, _ = _lowp_run(prec, tmp, kdir, LOWP_STEPS, probe)
        launches[f"train_{prec}"] = got = dict(_build.launches)
        print(f"kernel launches on the {prec} training path: {got}")
        need = [f"conv3d_ndhwc_{sfx}", f"conv3d_dgrad_{sfx}",
                f"conv3d_wgrad_{sfx}", f"conv3d_wgrad1_{sfx}",
                "optim_update_scaled" if prec == "f16"
                else "optim_update"] + list(TRAIN_K11)
        steps = len(krec.metrics)
        require(all(got.get(k, 0) > 0 for k in need) and not any(
            k.endswith("f32") for k in got), f"{prec} training launches "
                                             f"{got}")
        # Each step's 27 offsets: the 24 3^3 layers on the tensor-core K18,
        # conv_lom on its CUDA-core body.
        require(got[f"conv3d_wgrad_{sfx}"] == LOWP_K18_TC * steps and
                got[f"conv3d_wgrad1_{sfx}"] == LOWP_K18_CORE * steps,
                f"{prec}: K18 launches {got[f'conv3d_wgrad_{sfx}']} and "
                f"{got[f'conv3d_wgrad1_{sfx}']} in {steps} steps, want "
                f"{LOWP_K18_TC} and {LOWP_K18_CORE} a step")
        patches = _train_plain_patches() + _lowp_plain_patches()
        for p in patches:
            p.start()
        try:
            prec_, _ = _lowp_run(prec, tmp, kdir + "_plain", 2)
        finally:
            for p in patches:
                p.stop()
        km, pm = krec.metrics[0], prec_.metrics[0]
        loss_err = float(((km["loss"] - pm["loss"]).abs()
                          / pm["loss"].abs().clamp(min=1e-30)).max())
        param_err = max(float((krec.params1[k] - prec_.params1[k]).abs()
                              .max()) for k in krec.params1)
        same = {k: torch.equal(km[k], pm[k]) for k in (
            "active", "correct", "missed", "spurious", "grads_finite",
            "loss_scale")}
        print(f"train {prec} step 1, kernels vs plain: per-offset loss max "
              f"relative error {loss_err:.3e} (bound {LOWP_LOSS_RTOL}), "
              f"weights max abs error {param_err:.3e} (bound "
              f"{LOWP_PARAM_ATOL}); equal: {same}")
        require(loss_err <= LOWP_LOSS_RTOL and param_err <= LOWP_PARAM_ATOL
                and same["grads_finite"] and same["loss_scale"],
                f"train {prec} step 1: kernels against plain")
        if probe is not None:
            ms = probe.ms()
            print(f"K17 conv3d_dgrad_{sfx} launches a step by layer kind: "
                  + ", ".join(f"{k} {v / steps:g}" for k, v in sorted(
                      probe.dgrad_kinds.items())))
            print(f"train {prec}, CUDA-event ms a step by kernel (events "
                  f"around each call, {len(krec.metrics)} steps from the "
                  f"first; they span host gaps where the queue runs dry): "
                  + ", ".join(f"{k} {v / len(krec.metrics):.1f}"
                              for k, v in ms.items()))
        _lowp_profile(dev, prec)
        if prec != "f16":
            continue
        rdir = os.path.join(tmp, "train_f16_resumed")
        os.makedirs(os.path.join(rdir, "ckpt"))
        for p in ("model", "opt", "extra"):
            shutil.copy(os.path.join(kdir, "ckpt", f"{p}.ckpt-"
                                     f"{TRAIN_CKPT_EVERY}.npz"),
                        os.path.join(rdir, "ckpt"))
        probe = _KernelProbe(extra=True)
        rrec, _ = _lowp_run(prec, tmp, rdir, LOWP_STEPS, probe)
        a, b = (dict(_ckpt_arrays(d, LOWP_STEPS), **np.load(os.path.join(
            d, "ckpt", f"extra.ckpt-{LOWP_STEPS}.npz"))) for d in (kdir,
                                                                   rdir))
        same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                              for k in a)
        rms = probe.ms()
        print(f"f16 resume from step {TRAIN_CKPT_EVERY} to {LOWP_STEPS}: "
              f"weights, optimizer state, scale {a['scale0']} and counter "
              f"{a['scale1']} bit for bit {same}; CUDA-event ms a step by "
              f"kernel: " + ", ".join(
                  f"{k} {v / len(rrec.metrics):.1f}"
                  for k, v in rms.items()))
        require(same and "scale0" in a, "the f16 resume differs")

    hdir = os.path.join(tmp, "train_host_bf16")
    argv = _train_argv(tmp, hdir) + [
        "--precision", "bf16", "--trainer", "host_loop", "--fov_policy",
        "max_pred_moves", "--model_args", json.dumps(HOST_MODEL)]
    for flag in ("--max_steps", "--checkpoint_every_steps",
                 "--summary_every_steps"):
        argv[argv.index(flag) + 1] = str(LOWP_HOST_STEPS)
    rec = _HostRecorder()
    _build.launches.clear()
    with mock.patch.object(train_loop.train_lib, "make_fov_train_step",
                           rec.make(train_lib.make_fov_train_step)):
        train_cli.main(argv)
    torch.cuda.synchronize()
    launches["train_host_bf16"] = got = dict(_build.launches)
    steady_ms = rec.events[1].elapsed_time(rec.events[-1]) / (
        len(rec.events) - 2)
    print(f"train host_loop bf16: {len(rec.events)} steps, steady "
          f"{1e3 / steady_ms:.4f} steps/s; launches {got}")
    require(len(rec.events) == LOWP_HOST_STEPS and all(bool(torch.isfinite(
        v)) for v in rec.losses) and all(got.get(k, 0) > 0 for k in (
            "conv3d_ndhwc_bf16", "conv3d_dgrad_bf16", "conv3d_wgrad_bf16",
            "conv3d_wgrad1_bf16", "fov_loss", "optim_update")),
            "host loop bf16")
    return launches


# -- the host-loop trainer (phase 15) ----------------------------------------

HOST_STEPS = 40
HOST_LOSS_RTOL = 1e-4       # the first batch's fov step, kernels vs plain
HOST_LOGIT_TOL = 1e-4       # of max|plain logit|
HOST_PARAM_ATOL = 1e-5
HOST_KERNELS = ("conv3d_ndhwc_f32", "conv3d_dgrad_f32", "conv3d_wgrad_f32",
                "fov_loss", "optim_update")
# The train CLI's default model (its --model_args stated explicitly).
HOST_MODEL = dict(fov_size=[33] * 3, deltas=[8] * 3, depth=12, features=32)


class _HostRecorder:
    """Wraps make_fov_train_step: keeps the first batch and weights (copies),
    each loss, the parameters, a CUDA event a step, and the host's time in
    BatchExampleIter after the first two steps."""

    def __init__(self):
        self.losses, self.events = [], []
        self.first = self.init = self.params = None
        self.host_s = 0.0

    def make(self, make_step):
        def make_recorded(model, opt, mesh=None, config=None):
            step = make_step(model, opt, mesh=mesh, config=config)

            def run(params, *args):
                if self.first is None:
                    self.first = [t.clone() for t in args[-4:]]
                    self.init = {n: p.detach().clone()
                                 for n, p in params.items()}
                out = step(params, *args)
                self.params = params
                self.losses.append(out[-1])
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
                return out
            return run
        return make_recorded

    def timed(self, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if len(self.events) >= 2:
                    self.host_s += time.perf_counter() - t0
        return run


def phase_train_host(dev, tmp):
    """The host-loop trainer at full width through the train CLI (--trainer
    host_loop --fov_policy max_pred_moves, depth 12, 32 features, 33^3,
    batch 4, sgd, float32), 40 steps, kernels timed by CUDA events: finite
    losses, moves, the checkpoint restored bit for bit; then the first batch
    through make_fov_train_step on kernels and plain versions from the same
    weights (loss 1e-4 relative, logits 1e-4 of max|plain|, weights 1e-5).
    Returns the run's launches."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.cli import train as train_cli
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.training import examples
    from ffn_tpu_torch.training import train_lib, train_loop

    hdir = os.path.join(tmp, "train_host")
    argv = _train_argv(tmp, hdir)
    argv[argv.index("--max_steps") + 1] = str(HOST_STEPS)
    for flag in ("--checkpoint_every_steps", "--summary_every_steps"):
        argv[argv.index(flag) + 1] = str(HOST_STEPS)
    argv += ["--trainer", "host_loop", "--fov_policy", "max_pred_moves",
             "--model_args", json.dumps(HOST_MODEL)]
    rec = _HostRecorder()
    it = examples.BatchExampleIter
    patches = [mock.patch.object(train_loop.train_lib, "make_fov_train_step",
                                 rec.make(train_lib.make_fov_train_step)),
               mock.patch.object(it, "__next__", rec.timed(it.__next__)),
               mock.patch.object(it, "update_seeds",
                                 rec.timed(it.update_seeds))]
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _KernelProbe(train_kernels=("fov_loss",)) as probe:
        for p in patches:
            p.start()
        try:
            train_cli.main(argv)
        finally:
            for p in patches:
                p.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    print(f"kernel launches on the host-loop training path: {launches}")
    for name in HOST_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the host-loop path")
    steps = len(rec.events)
    require(steps == HOST_STEPS, f"host loop: {steps} steps")
    require(all(bool(torch.isfinite(v)) for v in rec.losses),
            "host loop: non-finite loss")
    steady_ms = rec.events[1].elapsed_time(rec.events[-1]) / (steps - 2)
    device_ms = probe.ms()
    busy = sum(device_ms.values()) / steps
    host_ms = 1e3 * rec.host_s / (steps - 2)
    with open(os.path.join(hdir, "summaries.jsonl")) as f:
        summary = json.loads(f.readlines()[-1])
    losses = [float(v) for v in rec.losses]
    print(f"train host_loop: {steps} steps in {wall:.3f} s; steady "
          f"{1e3 / steady_ms:.4f} steps/s ({steady_ms:.3f} ms a step); "
          f"device ms a step: " + ", ".join(
              f"{n} {v / steps:.3f}" for n, v in device_ms.items())
          + f"; busy {busy / steady_ms:.4f}; host (BatchExampleIter) "
          f"{host_ms:.3f} ms a step, {host_ms / steady_ms:.4f}; moves "
          f"{summary['moves/total']}, correct "
          f"{summary['moves/correct']:.4f}; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")
    require(summary["step"] == HOST_STEPS and summary["moves/total"] > 0,
            f"host loop summaries: {summary}")

    # The checkpoint, read back by the port's _restore.
    ckpt = os.path.join(hdir, "ckpt")
    names = sorted(os.listdir(ckpt))
    require(names == [f"{p}.ckpt-{HOST_STEPS}.npz" for p in
                      ("extra", "model", "opt")], f"checkpoints: {names}")
    config = train_lib.TrainConfig(
        fov_size=HOST_MODEL["fov_size"], deltas=HOST_MODEL["deltas"],
        depth=HOST_MODEL["depth"], features=HOST_MODEL["features"],
        batch_size=TRAIN_B, fov_policy="max_pred_moves")

    def fresh(weights):
        model = convstack_3d.ConvStack3DFFNModel(**HOST_MODEL)
        model.module.to(dev)
        if weights is not None:
            with torch.no_grad():
                for n, p in model.module.named_parameters():
                    p.copy_(weights[n])
        state, opt = train_lib.create_train_state(model, config)
        return model, state, opt

    model, state, opt = fresh(None)
    train_loop._restore(ckpt, HOST_STEPS, model, opt, state.opt_state)
    require(all(torch.equal(p, rec.params[n]) and bool(torch.isfinite(
        p).all()) for n, p in state.params.items()),
        "the restored checkpoint differs from the run's final weights")
    print(f"model.ckpt-{HOST_STEPS}.npz restored by train_loop._restore: "
          f"equal to the run's final weights, all finite")

    # The first batch through the fov step, on kernels and plain.
    def fov_step():
        model, state, opt = fresh(rec.init)
        step = train_lib.make_fov_train_step(model, opt, config=config)
        out = step(state.params, state.opt_state, state.ema_params,
                   state.scale_state, *rec.first)
        return out[-2], out[-1], state.params

    klogits, kloss, kparams = fov_step()
    plain = _train_plain_patches()
    for p in plain:
        p.start()
    try:
        plogits, ploss, pparams = fov_step()
    finally:
        for p in plain:
            p.stop()
    loss_err = abs(float(kloss) - float(ploss)) / max(abs(float(ploss)),
                                                      1e-30)
    logit_err = _rel_err(klogits, plogits)
    param_err = max(float((kparams[n] - pparams[n]).detach().abs().max())
                    for n in kparams)
    print(f"host-loop first batch, kernels vs plain: loss {loss_err:.3e} "
          f"relative, logits {logit_err:.3e} of max, weights {param_err:.3e}")
    require(loss_err <= HOST_LOSS_RTOL, f"host fov step loss: {loss_err}")
    require(logit_err <= HOST_LOGIT_TOL, f"host fov step logits: {logit_err}")
    require(param_err <= HOST_PARAM_ATOL,
            f"host fov step weights: {param_err}")
    return launches


def _train_profile(dev):
    """torch.profiler over one full-width packed step (after a warm-up
    step): what runs on the card is the port's kernels, the autograd nodes
    are its two Functions, and neither cuDNN nor another convolution
    runs."""
    from torch.profiler import ProfilerActivity, profile
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.training import train_lib
    torch.manual_seed(0)
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, features=32)
    model.module.to(dev)
    config = train_lib.TrainConfig(batch_size=TRAIN_B)
    state, opt = train_lib.create_train_state(model, config)
    step = train_lib.make_scan_train_step_packed(model, opt, config)
    rng = np.random.RandomState(0)
    shape = (TRAIN_B,) + (TRAIN_CANVAS,) * 3 + (1,)
    image = torch.from_numpy(rng.randint(0, 256, shape).astype(
        np.uint8)).to(dev)
    lom = torch.from_numpy((rng.rand(*shape) > 0.5).astype(np.uint8)).to(dev)
    offsets = train_lib.fixed_offsets_zyx(model.info)
    step(state, image, lom, offsets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, image, lom, offsets)
        torch.cuda.synchronize()
    kernels, nodes, foreign = _profile_findings(prof.key_averages())
    total = sum(us for _, _, us in kernels)
    print(f"one training step under torch.profiler: {total / 1e3:.1f} "
          f"device ms in {len(kernels)} kernels")
    for name, count, us in kernels:
        print(f"  {us / 1e3:10.4f} ms {count:5d}x {name}")
    print(f"  autograd nodes: {nodes}")
    require(not foreign, f"the training step ran foreign kernels: {foreign}")
    require(nodes <= {"Conv3dFunctionBackward",
                      "ResidualBlockFunctionBackward"},
            f"autograd nodes beyond the port's Functions: {nodes}")


def _profile_findings(events):
    """(kernels as (short name, count, device us), autograd node names,
    cuDNN or other convolution kernels) of profiler key averages."""
    def short(name):
        name = name[len("void "):] if name.startswith("void ") else name
        return name.replace("(anonymous namespace)::", "").split("(")[0]

    kernels = sorted(((short(e.key), e.count, e.device_time_total)
                      for e in events
                      if e.device_time_total > 0 and "::" in e.key
                      and not e.key.startswith(("aten::", "autograd::"))),
                     key=lambda r: -r[2])
    prefix = "autograd::engine::evaluate_function: "
    nodes = {e.key[len(prefix):] if e.key.startswith(prefix) else e.key
             for e in events if re.search(r"Backward\d*$", e.key)}
    foreign = [e.key for e in events if e.device_time_total > 0 and (
        "cudnn" in e.key.lower() or "xmma" in e.key.lower()
        or ("conv" in e.key.lower() and "::" in e.key
            and "(anonymous namespace)::conv3d_" not in e.key
            and not e.key.startswith(("aten::", "autograd::"))))]
    return kernels, nodes, foreign


def _train_golden(dev):
    """The CI model's two packed steps against the JAX package's CPU run."""
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.training import optimizer as optimizer_lib
    from ffn_tpu_torch.training import train_lib
    g = np.load(os.path.join(REPO, "tests", "golden", "train_ci_golden.npz"))
    init = {k[len("init/"):]: g[k] for k in g.files if k.startswith("init/")}
    for opt in ("sgd", "adam"):
        model = convstack_3d.ConvStack3DFFNModel(
            fov_size=[17] * 3, deltas=[4] * 3, depth=2, features=16)
        model.load_params(init)
        model.module.to(dev)
        config = train_lib.TrainConfig(
            fov_size=(17,) * 3, deltas=(4,) * 3, depth=2, features=16,
            batch_size=4, optimizer=optimizer_lib.OptimizerConfig(
                optimizer=opt, learning_rate=0.001, epsilon=1e-3))
        state, optimizer = train_lib.create_train_state(model, config)
        step = train_lib.make_scan_train_step_packed(model, optimizer,
                                                     config)
        loss_err = 0.0
        for s in range(2):
            state, m = step(state, torch.from_numpy(g["image_u8"][s]).to(dev),
                            torch.from_numpy(g["lom_u8"][s]).to(dev),
                            g["offsets"])
            for k in ("active", "correct", "missed", "spurious", "tp", "fp",
                      "fn", "tn"):
                got = m[k].cpu().numpy()
                require(np.array_equal(got, g[f"{opt}/{k}"][s]),
                        f"train golden {opt} step {s + 1} {k}: {got} vs "
                        f"{g[f'{opt}/{k}'][s]}")
            for k in ("loss", "patch_loss"):
                got, want = m[k].cpu().numpy(), g[f"{opt}/{k}"][s]
                loss_err = max(loss_err, float(np.max(
                    np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
        param_err = max(
            float(np.abs(p.detach().cpu().numpy()
                         - g[f"{opt}/final/params/{n.split('.')[0]}/"
                             f"{'kernel' if n.endswith('weight') else 'bias'}"]
                         ).max())
            for n, p in state.params.items())
        print(f"train golden {opt} (CI model, 2 packed steps, batch 4): "
              f"counts equal, loss max relative error {loss_err:.3e} (bound "
              f"{TRAIN_GOLDEN_LOSS_RTOL}), weights max abs error "
              f"{param_err:.3e} (bound {TRAIN_GOLDEN_PARAM_ATOL})")
        require(loss_err <= TRAIN_GOLDEN_LOSS_RTOL,
                f"train golden {opt} loss: {loss_err}")
        require(param_err <= TRAIN_GOLDEN_PARAM_ATOL,
                f"train golden {opt} weights: {param_err}")


def _train_inference(dev, tmp, kdir):
    """The trained checkpoint in the port's serial Runner, on a 64^3 corner
    of the training phantom."""
    from ffn_tpu_torch.inference import runner as runner_lib
    from ffn_tpu_torch.inference import storage
    ckpt = os.path.join(kdir, "ckpt", f"model.ckpt-{TRAIN_STEPS}.npz")
    settings = _settings(os.path.join(tmp, "train_img.npy"),
                         os.path.join(tmp, "train_infer"))
    settings = dataclasses.replace(settings, model_checkpoint_path=ckpt)
    runner = runner_lib.Runner(device=dev)
    runner.start(settings)
    t0 = time.perf_counter()
    runner.run((0, 0, 0), (64, 64, 64), keep_probability_maps=False)
    wall = time.perf_counter() - t0
    seg_path = storage.segmentation_path(settings.segmentation_output_dir,
                                         (0, 0, 0))
    with np.load(seg_path, allow_pickle=True) as data:
        seg = data["segmentation"]
    steps = runner.counters["update_at-calls"].value
    print(f"inference with the trained model.ckpt-{TRAIN_STEPS}.npz (serial "
          f"Runner, 64^3): {steps} FOV steps in {wall:.3f} s, "
          f"{len(np.unique(seg[seg > 0]))} objects")
    require(seg.shape == (64, 64, 64) and steps > 0,
            "inference with the trained checkpoint did not run")


def _q_layer(rng, dev, n, k, cin, cout, res):
    """A folded random int8 layer and inputs on N 33^3 lanes of magnitudes
    1e-2 to 1e2, lane N // 2 all zero (N > 1)."""
    from ffn_tpu_torch.ops import quantized as q
    layer = q.fold_convstack_params({"c": {
        "kernel": rng.randn(k, k, k, cin, cout).astype(np.float32) * 0.05,
        "bias": rng.randn(cout).astype(np.float32)}})["c"].to(dev)
    mag = 10.0 ** rng.randint(-2, 3, (n, 1, 1, 1, 1))
    x = torch.from_numpy((rng.randn(n, 33, 33, 33, cin) * mag).astype(
        np.float32)).to(dev)
    if n > 1:
        x[n // 2] = 0
    r = torch.randn(n, 33, 33, 33, cout, device=dev) if res else None
    return layer, x, r


def phase_int8_kernels(dev):
    """K19 qconv3d_s8 and K20 act_absmax against their plain versions bit
    for bit on model-r2's int8 layer kinds at N = 1 and 64 (a lane alone
    equal to the batch's), timed at N = 1 (block_a) and 64 beside one
    library call (K19: torch._int_mm on the int8 im2col, the GEMM alone,
    32->32 layers; K20: torch.linalg.vector_norm(ord=inf), max|x| per
    lane); K20 one launch a call (torch.profiler); the int8 model-r2 stack
    at N = 8 on kernels equal to its plain versions."""
    from ffn_tpu_torch.models import convstack_3d, params_io
    from ffn_tpu_torch.ops import quantized as q
    rng = np.random.RandomState(19)
    out = {}
    for n in (1, LANES):
        for name, (k, cin, cout, ri, ro, res) in Q_LAYERS.items():
            layer, x, r = _q_layer(rng, dev, n, k, cin, cout, res)
            kw = dict(relu_in=ri, relu_out=ro, residual=r)
            am, am_p = q.act_absmax(x, ri), q.act_absmax_plain(x, ri)
            got = q.qconv3d(x, layer, am, **kw)
            same = (torch.equal(am, am_p), torch.equal(
                got, q.qconv3d_plain(x, layer, am_p, **kw)),
                torch.equal(q.qconv3d(x[-1:], layer, am[-1:], **dict(
                    kw, residual=None if r is None else r[-1:])), got[-1:]))
            print(f"K19/K20 int8 N={n} {name}: K20 equal {same[0]}, K19 "
                  f"equal {same[1]}, last lane alone equal {same[2]}")
            require(all(same) and bool(got.isfinite().all()),
                    f"K19/K20 N={n} {name} against plain: {same}")
            if n != LANES and name != "block_a":
                continue
            lib = [lambda: torch.linalg.vector_norm(x, float("inf"),
                                                    dim=(1, 2, 3, 4))]
            if cin == 32 and k == 3:
                xq = torch.nn.functional.pad(torch.clamp(torch.round(
                    x / (am * q.C127).view(-1, 1, 1, 1, 1)), -127, 127).to(
                    torch.int8), (0, 0, 1, 1, 1, 1, 1, 1))
                cols = torch.cat([xq[:, t // 9:t // 9 + 33,
                                     t // 3 % 3:t // 3 % 3 + 33,
                                     t % 3:t % 3 + 33] for t in range(27)],
                                 dim=-1).reshape(-1, 27 * cin)
                del xq
                lib.append(lambda: torch._int_mm(cols, layer.w_q))
            ms = time_many(lambda: q.qconv3d(x, layer, am, **kw),
                           lambda: q.qconv3d_plain(x, layer, am, **kw),
                           lambda: q.act_absmax(x, ri),
                           lambda: q.act_absmax_plain(x, ri), *lib,
                           reps=REPS if name == "block_a" and n == LANES
                           else 5, inner=3)
            vox = n * 33 ** 3
            k19 = entry(0.0, ms[0], ms[1], 4 * vox * (
                cin + cout * (2 if res else 1)) + k ** 3 * cin * cout
                + 8 * cout, 2 * vox * k ** 3 * cin * cout,
                library_ms=ms[5] if len(ms) > 5 else None, peak=INT8_OPS)
            k20 = entry(0.0, ms[2], ms[3], 4 * vox * cin + 4 * n,
                        library_ms=ms[4])
            print(f"K19 qconv3d_s8 N={n} {name}: kernel {ms[0]:.4f} ms plain "
                  f"{ms[1]:.4f} library (_int_mm) {k19['library_ms']} bound "
                  f"{k19['bound_ms']:.4f} ({k19['bound_by']}); K20 "
                  f"act_absmax {ms[2]:.4f} plain {ms[3]:.4f} library "
                  f"(vector_norm) {ms[4]:.4f} bound {k20['bound_ms']:.4f}")
            if name == "block_a" and n == LANES:
                out["qconv3d_s8"], out["act_absmax"] = k19, k20
            del x, r, got, lib, layer
            cols = None
        torch.cuda.empty_cache()
    # K20 is one launch a call: its counters stay zero between calls, no
    # memset (torch.profiler's device events of one steady call).
    x = torch.randn(LANES, 33, 33, 33, 32, device=dev)
    q.act_absmax(x, True)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        q.act_absmax(x, True)
        torch.cuda.synchronize()
    device = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    events = [ev.name for ev in device]
    us = sum(getattr(ev, "device_time", None) or ev.cuda_time
             for ev in device)
    print(f"K20 act_absmax at N={LANES}, one call under torch.profiler: "
          f"device events {events}, {us:.1f} us")
    require(len(events) == 1 and "act_absmax" in events[0],
            f"K20 launched {events}, not one kernel")
    del x
    base = convstack_3d.ConvStack3DFFNModel(fov_size=[33] * 3,
                                            deltas=[8] * 3, depth=12)
    base.load_params(params_io.load_params_npz(
        os.path.join(REPO, "models", "phantom", "model-r2.npz")))
    model = q.QuantizedConvStack3DModel(base)
    model.prepare()
    model.to(dev)
    img = torch.randn(8, 33, 33, 33, 1, device=dev)
    sd = torch.randn(8, 33, 33, 33, 1, device=dev) * 3
    got = model.apply(img, sd)
    with contextlib.ExitStack() as stack:
        for patch in _plain(q, "qconv3d", "act_absmax"):
            stack.enter_context(patch)
        want = model.apply(img, sd)
    one = model.apply(img[5:6], sd[5:6])
    require(torch.equal(got, want) and torch.equal(one[0], got[5]),
            "the int8 model-r2 stack on kernels differs from plain")
    print("int8 model-r2 stack (depth 12, N=8): kernels = plain versions, "
          "lane 5 alone = in the batch, bit for bit")
    return out


def phase_device_alone(dev):
    """K10 (32->32 pre+post_relu, B = 4 and 1) and K19 (block_a, N = 1 and
    64) on the device alone beside their library calls (cuDNN's
    conv3d_weight; torch._int_mm on the int8 im2col), and K8's crafted and
    empty passes (_k8_state), by torch.profiler:
    the wrappers' host time left out. Runs after every other profiled check
    of phase 3 (K20's one-launch check needs the process's first profiler
    run: after others it saw no device events)."""
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import quantized as q
    gen = torch.Generator(device=dev).manual_seed(17)
    for b in (TRAIN_B, 1):
        x = torch.randn(b, 33, 33, 33, 32, generator=gen, device=dev)
        dy = torch.randn(b, 33, 33, 33, 32, generator=gen, device=dev)
        y = torch.randn(b, 33, 33, 33, 32, generator=gen, device=dev)
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        gc = dy.permute(0, 4, 1, 2, 3).contiguous()
        ms = device_alone_ms(
            lambda: conv3d.conv3d_wgrad_f32(x, dy, 3, pre_relu=True, y=y),
            lambda: torch.nn.grad.conv3d_weight(xc, (32, 32, 3, 3, 3), gc,
                                                padding=1))
        print(f"K10 conv3d_wgrad_f32 32->32 pre+post_relu B={b}: device "
              f"alone {ms[0]:.4f} ms, library conv3d_weight {ms[1]:.4f} ms "
              f"(torch.profiler)")
        del x, dy, y, xc, gc
    rng = np.random.RandomState(17)
    k, cin, cout, ri, ro, res = Q_LAYERS["block_a"]
    for n in (1, LANES):
        layer, x, _ = _q_layer(rng, dev, n, k, cin, cout, res)
        am = q.act_absmax(x, ri)
        xq = torch.nn.functional.pad(torch.clamp(torch.round(
            x / (am * q.C127).view(-1, 1, 1, 1, 1)), -127, 127).to(
            torch.int8), (0, 0, 1, 1, 1, 1, 1, 1))
        cols = torch.cat([xq[:, t // 9:t // 9 + 33,
                             t // 3 % 3:t // 3 % 3 + 33, t % 3:t % 3 + 33]
                          for t in range(27)], dim=-1).reshape(-1, 27 * cin)
        del xq
        ms = device_alone_ms(
            lambda: q.qconv3d(x, layer, am, relu_in=ri, relu_out=ro),
            lambda: torch._int_mm(cols, layer.w_q))
        print(f"K19 qconv3d_s8 N={n} block_a: device alone {ms[0]:.4f} ms, "
              f"library _int_mm {ms[1]:.4f} ms (torch.profiler)")
        del layer, x, am, cols
    torch.cuda.empty_cache()

    # K8 on _k8_state's crafted pass (each call from the restored state)
    # and on a pass that finalizes nothing: its kernel's events alone.
    from ffn_tpu_torch.ops import finalize as fin_ops
    for seed_dtype in (torch.bfloat16, torch.float32):
        tk, state, blk, opts, kw, _ = _k8_state(dev, seed_dtype)
        work, snap = state(), state()

        def restore():
            for w, s in zip(work, snap):
                for name in w:
                    w[name].copy_(s[name])
        out = []
        for empty in (False, True):
            if empty:
                _k8_empty(snap)
            restore()
            tk.finalize_step(fin_ops.finalize_pass, *work, blk, opts, **kw)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    restore()
                    tk.finalize_step(fin_ops.finalize_pass, *work, blk, opts,
                                     **kw)
                torch.cuda.synchronize()
            out.append(sum(
                getattr(ev, "device_time_total", None) or ev.cuda_time_total
                for ev in prof.key_averages()
                if "finalize_pass" in ev.key) / 10 / 1e3)
        print(f"K8 finalize_pass{'_bf16' if seed_dtype == torch.bfloat16 else ''}"
              f": device alone {out[0]:.4f} ms a crafted pass, {out[1]:.4f} "
              f"ms a pass that finalizes nothing (torch.profiler)")
        del work, snap, blk
        torch.cuda.empty_cache()
    return {}


def phase_int8_slices(dev, phantom, r2, tmp):
    """int8 inference at full width (model-r2 through FFN_TPU_PRECISION=int8,
    the JAX CLIs' switch) on phase 5's phantom: the serial slice, the
    64-lane hop slice and the sharded CLI's fused slice on K19/K20, with no
    other conv launched; rates, objects and agreement beside the float32
    and bf16 slices'. Each also on K19/K20's plain versions on one 64^3
    corner of the phantom (FUSED_PAIR_BOX; the whole hop slice's plain run
    took 256-271 s), equal in voxels, origins, counters and moves. Returns
    the kernel runs' launches (serial_int8, hop_int8, fused_int8)."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import quantized as q
    int8 = mock.patch.dict(os.environ, {"FFN_TPU_PRECISION": "int8"})
    edge = FUSED_PAIR_BOX[0]
    corner = _corner(phantom)
    launches, runs = {}, {}
    with int8:
        for path, lanes, hops in (("serial_int8", 1, None),
                                  ("hop_int8", LANES, HOPS)):
            settings = dataclasses.replace(r2, concurrent_requests=lanes)
            _build.launches.clear()
            runs[path] = _run_slice(
                f"{lanes} lanes, int8, model-r2, on kernels",
                dataclasses.replace(settings, segmentation_output_dir=(
                    os.path.join(tmp, path))), dev, **phantom, hops=hops)
            launches[path] = dict(_build.launches)
            _pair(f"the {path} slice on {edge}^3", lambda label, sfx: (
                _run_slice(f"{lanes} lanes, int8, model-r2, {edge}^3, {label}",
                           dataclasses.replace(
                               settings, segmentation_output_dir=os.path.join(
                                   tmp, f"{path}_pair{sfx}")), dev, **corner,
                           hops=hops)), _plain(q, "qconv3d", "act_absmax"))
        model_args = {"depth": 12, "fov_size": [33] * 3, "deltas": [8] * 3}
        run = _fused("fused_int8 slice on kernels", "fused_int8", tmp,
                     model_args)
        launches["fused_int8"] = run["launches"]
        stitch_s, stitched = _stitch(run["argv"], os.path.join(
            tmp, "fused_int8.npz"), as_process=False)
        run["agree"] = _stitched_agreement("fused_int8 slice", stitch_s,
                                           stitched, phantom["gt"])
        runs["fused_int8"] = dict(run, seg=stitched)
        _pair("the fused_int8 slice on one subvolume", lambda label, sfx:
              _fused(f"fused_int8 slice on one subvolume {label}",
                     f"fused_int8_pair{sfx}", tmp, model_args,
                     size=FUSED_PAIR_BOX), _plain(q, "qconv3d", "act_absmax"),
              keys=("subs", "moves"))
    for path, got in runs.items():
        _require_launched(launches[path], f"the {path} path",
                          ("qconv3d_s8", "act_absmax"),
                          absent=("conv3d_ndhwc_f32", "conv3d_ndhwc_bf16"))
        kind = path.split("_")[0]
        _note(kind, "int8", got)
        print(f"{path}: " + "; ".join(
            f"{prec} {rate:.2f} {'steps' if kind == 'serial' else 'moves'}"
            f"/s, {objects} objects, agreement {agree:.4f}"
            for (p, prec), (rate, objects, agree) in SLICE_RATES.items()
            if p == kind) + " (bf16 hop: 8 lanes)")
        require(got["agree"] >= INT8_FLOORS[path], f"{path} agreement "
                f"{got['agree']} below its floor {INT8_FLOORS[path]}")
    return launches


# Phase 19: ResConvStack (K21 with K1/K15) and edges (K22, K23).
RES_DEPTH = 20       # the LICONN notebook's ResConvStack
# Of max|plain logit|: K1's stack tolerance in float32. In bfloat16 the
# kernels equal the stack with float64 sums (K15's function) bit for bit;
# against the plain layers' float32 sums (cuDNN's order) the 19 residual
# adds, each rounded to bfloat16 (ulp 2^-4 at the stream's 8-16), drift by
# a few ulps: 2.25% of max|logit| measured (NVIDIA H100 80GB HBM3, 700 W),
# above K15_STACK_TOL's 2^-6 for the depth-12 stack.
RES_STACK_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}
EDGE_SIZES = (PHANTOM_SIZE + 2 * PHANTOM_PAD, 250)   # padded phantom, demo


def _res_model(dev, dt):
    """A depth-20, 32-feature ResConvStack with random weights from a seed:
    He-scaled kernels, biases 0.1 N(0, 1), LayerNorm scale 1 + 0.2 N(0, 1)
    and bias 0.1 N(0, 1)."""
    from ffn_tpu_torch.models import convstack_3d
    gen = torch.Generator().manual_seed(21)
    model = convstack_3d.ResConvStack(depth=RES_DEPTH, features=32,
                                      compute_dtype=dt)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if name.endswith("weight"):
                p.copy_(r * (2.0 / p[..., 0].numel()) ** 0.5)
            else:
                p.copy_(r * (0.2 if name.endswith("scale") else 0.1)
                        + (1.0 if name.endswith("scale") else 0.0))
    model.round_params()
    return model.to(dev)


def _res_plain(convstack_3d):
    """ResConvStack's layers on their plain versions."""
    from ffn_tpu_torch.ops import conv3d, layernorm
    return [mock.patch.object(convstack_3d, "layernorm_channels",
                              layernorm.layernorm_channels_plain),
            mock.patch.object(convstack_3d, "conv3d_ndhwc_f32",
                              conv3d.conv3d_ndhwc_plain),
            mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                              conv3d.conv3d_ndhwc_bf16_plain)]


def phase_remaining_programs(dev):
    """The last two TPU programs, which no path of either package calls:
    K21 layernorm_channels against its plain version bit for bit at N = 1
    and 64 (33^3 x 32) in float32, bfloat16 and float16, timed at N=64
    (float32) beside F.layer_norm; ResConvStack (depth 20, 32 features, 2
    inputs, 33^3, random weights) at N = 1 and 64 in float32 and bfloat16
    on K21 + K1/K15 against its plain layers (RES_STACK_TOL), in bfloat16
    equal to the stack with float64 sums, N=1 equal to the batch's sample,
    its N=64 forward timed; K22 edges_sobel and K23 edges_blur against
    edges_plain bit for bit (the magnitude, each blur pass, the mask) on
    the padded 132^3 phantom and the 250^3 demo volume, timed at 250^3;
    edges() launching K22 once and K23 three times. Returns (results,
    launches of the paths resconv (the N=64 forwards) and edges (edges()
    on the 250^3 volume))."""
    import torch.nn.functional as F
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d_bf16_check as check
    from ffn_tpu_torch.ops import image, layernorm
    sys.path.insert(0, REPO)
    from tools import synthetic_em
    results, launches = {}, {}
    gen = torch.Generator(device=dev).manual_seed(21)
    k21_err = 0.0
    for n in (1, LANES):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(n, 33, 33, 33, 32, generator=gen,
                            device=dev).to(dt)
            scale = 1.0 + 0.5 * torch.randn(32, generator=gen, device=dev)
            bias = 0.3 * torch.randn(32, generator=gen, device=dev)
            got = layernorm.layernorm_channels(x, scale, bias)
            want = layernorm.layernorm_channels_plain(x, scale, bias)
            same = torch.equal(got, want)
            err = float((got.float() - want.float()).abs().max())
            k21_err = max(k21_err, err)
            print(f"K21 layernorm_channels N={n} {dt}: bit for bit {same} "
                  f"(max_abs_err {err:.3e})")
            require(same and bool(torch.isfinite(got).all()),
                    f"K21 N={n} {dt} differs from its plain version")
            if n == LANES and dt == torch.float32:
                ms = time_many(
                    lambda: layernorm.layernorm_channels(x, scale, bias),
                    lambda: layernorm.layernorm_channels_plain(x, scale,
                                                               bias),
                    lambda: F.layer_norm(x, (32,), scale, bias, eps=1e-6))
                vox = n * 33 ** 3
                results[layernorm.NAME] = entry(
                    err, ms[0], ms[1], 2 * 4 * vox * 32 + 2 * 4 * 32,
                    7 * vox * 32, library_ms=ms[2])
                e = results[layernorm.NAME]
                print(f"K21 N={n} float32: kernel {ms[0]:.4f} ms plain "
                      f"{ms[1]:.4f} ms library (F.layer_norm) {ms[2]:.4f} "
                      f"ms bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
            del x, got, want
    results[layernorm.NAME]["max_abs_err"] = k21_err
    torch.cuda.empty_cache()

    launches["resconv"] = {}
    for dt in (torch.float32, torch.bfloat16):
        model = _res_model(dev, dt)
        x = torch.randn(LANES, 33, 33, 33, 2, generator=gen, device=dev)
        with torch.no_grad():
            _build.launches.clear()
            got = model(x)
            for name, count in _build.launches.items():
                launches["resconv"][name] = launches["resconv"].get(
                    name, 0) + count
            one = model(x[:1].contiguous())
            with contextlib.ExitStack() as stack:
                for patch in _res_plain(convstack_3d):
                    stack.enter_context(patch)
                want = model(x)
                want_one = model(x[:1].contiguous())
                plain_ms = time_many(lambda: model(x), reps=3, inner=1)[0]
                if dt != torch.float32:
                    # K15's function: the plain layers with float64 sums.
                    stack.enter_context(mock.patch.object(
                        convstack_3d, "conv3d_ndhwc_bf16",
                        check.conv3d_ndhwc_bf16_exact))
                    exact = (torch.equal(got, model(x)) and
                             torch.equal(one, model(x[:1].contiguous())))
            ms = time_many(lambda: model(x), reps=3, inner=1)[0]
        tol = RES_STACK_TOL[dt]
        err = float((got - want).abs().max())
        err_one = float((one - want_one).abs().max())
        print(f"ResConvStack depth {RES_DEPTH} {dt} N={LANES}: max_abs_err "
              f"{err:.4e} against its plain layers (bound "
              f"{tol * float(want.abs().max()):.4e}, max|plain logit| "
              f"{float(want.abs().max()):.4f}); N=1 {err_one:.4e}; N=1 = "
              f"the batch's sample 0: {torch.equal(one[0], got[0])}"
              + ("" if dt == torch.float32 else
                 f"; N=64 and N=1 equal to the stack with float64 sums: "
                 f"{exact}") + f"; forward {ms:.2f} ms on kernels, "
              f"{plain_ms:.2f} ms plain")
        require(got.dtype == torch.float32 and got.shape == (
            LANES, 33, 33, 33, 1) and bool(torch.isfinite(got).all())
            and err <= tol * float(want.abs().max()) and err_one <= tol
            * float(want_one.abs().max()) and torch.equal(one[0], got[0])
            and (dt == torch.float32 or exact),
            f"ResConvStack {dt} on kernels against its plain layers")
        del model, x, got, want, one, want_one
        torch.cuda.empty_cache()
    print(f"resconv launches: {launches['resconv']}")
    _require_launched(launches["resconv"], "the ResConvStack forwards",
                      (layernorm.NAME, "conv3d_ndhwc_f32",
                       "conv3d_ndhwc_bf16"))

    img_small, _ = synthetic_em.make_volume(size=PHANTOM_SIZE, seed=0,
                                            num_cells=PHANTOM_CELLS)
    vols = {EDGE_SIZES[0]: np.pad(img_small, PHANTOM_PAD, mode="reflect")}
    t0 = time.perf_counter()
    vols[EDGE_SIZES[1]] = synthetic_em.make_volume(size=EDGE_SIZES[1],
                                                   seed=0)[0]
    print(f"the {EDGE_SIZES[1]}^3 demo volume made in "
          f"{time.perf_counter() - t0:.1f} s")
    for size, vol in vols.items():
        img = torch.from_numpy(vol).to(dev).float()
        taps = image.gaussian_taps(device=dev)
        mag = image.edges_sobel(img)
        want = image.edges_sobel_plain(img)
        same = [torch.equal(mag, want)]
        sobel_err = float((mag - want).abs().max())
        blur, blur_err = mag, 0.0
        for axis in range(3):
            nxt = image.edges_blur(blur, taps, axis)
            want = image.edges_blur_plain(blur, taps, axis)
            same.append(torch.equal(nxt, want))
            blur_err = max(blur_err, float((nxt - want).abs().max()))
            blur = nxt
        del want
        if size == EDGE_SIZES[1]:
            _build.launches.clear()
        mask = image.edges(vol)   # a numpy array goes to the card
        if size == EDGE_SIZES[1]:
            launches["edges"] = dict(_build.launches)
        mask_plain = image.edges_plain(img)
        same += [torch.equal(mask, mag > blur),
                 torch.equal(mask, mask_plain)]
        # K23's function ends in the mask: a differing voxel counts 1.
        blur_err = max(blur_err, float((mask != mask_plain).any()))
        del mask_plain
        print(f"K22/K23 edges on {size}^3: magnitude, three blur passes, "
              f"mask, edges_plain's mask bit for bit: {same}; "
              f"{float(mask.float().mean()):.4f} of voxels are edges")
        require(all(same), f"K22/K23 on {size}^3 differ from plain")
        if size != EDGE_SIZES[1]:
            continue

        def k23():
            image.edges_blur(image.edges_blur(image.edges_blur(
                mag, taps, 0), taps, 1), taps, 2, edges=mag)

        def k23_plain():
            image.edges_blur_plain(image.edges_blur_plain(
                image.edges_blur_plain(mag, taps, 0), taps, 1), taps, 2,
                edges=mag)
        ms = time_many(lambda: image.edges_sobel(img),
                       lambda: image.edges_sobel_plain(img), k23, k23_plain,
                       lambda: image.edges(img), reps=5, inner=3)
        vox = size ** 3
        ntaps = taps.shape[0]
        results[image.SOBEL] = entry(sobel_err, ms[0], ms[1], 8 * vox,
                                     61 * vox)
        # K23's function: mask = edges > the three passes' blur of edges.
        results[image.BLUR] = entry(blur_err, ms[2], ms[3],
                                    5 * vox + 4 * ntaps,
                                    (3 * 2 * ntaps + 1) * vox)
        whole = bound_of(5 * vox, (61 + 3 * 2 * ntaps + 1) * vox)
        print(f"K22 edges_sobel {size}^3: kernel {ms[0]:.4f} ms plain "
              f"{ms[1]:.4f} ms bound {results[image.SOBEL]['bound_ms']:.4f}"
              f" ms ({results[image.SOBEL]['bound_by']}); K23 edges_blur x3 "
              f"(mask): kernel {ms[2]:.4f} ms plain {ms[3]:.4f} ms bound "
              f"{results[image.BLUR]['bound_ms']:.4f} ms "
              f"({results[image.BLUR]['bound_by']}); edges() {ms[4]:.4f} "
              f"ms, bound {whole[0]:.4f} ms ({whole[1]})")
    print(f"edges launches: {launches['edges']}")
    require(launches["edges"] == {image.SOBEL: 1, image.BLUR: 3},
            f"edges() launched {launches['edges']}")
    return results, launches


def _lanes_vs_serial(lanes, label, phantom, seg_serial, seg_lanes):
    """Cell-restricted agreement (both masked to the ground-truth cells) and
    raw agreement of a serial and a batched segmentation."""
    from tools import synthetic_em
    fg = phantom["gt"] > 0
    a, b = np.where(fg, seg_serial, 0), np.where(fg, seg_lanes, 0)
    cells = synthetic_em.object_level_agreement(a, b)
    raw = synthetic_em.object_level_agreement(seg_serial, seg_lanes)

    def big(seg):
        ids, n = np.unique(seg[seg > 0], return_counts=True)
        return int((n >= 1000).sum())

    print(f"lanes-{lanes} vs serial, {label}: cell-restricted "
          f"agreement {cells:.4f} (target 0.99), raw {raw:.4f}; objects of "
          f">= 1000 voxels inside the cells: serial {big(a)}, lanes "
          f"{big(b)}")
    return cells


def _clock(t0, what):
    print(f"[{time.perf_counter() - t0:.1f} s] {what} done", flush=True)


def main():
    t0 = time.perf_counter()
    phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = {}
    for phase in (phase_kernels, phase_hop_kernels, phase_fused_kernels,
                  phase_train_kernels, phase_select_kernels,
                  phase_bf16_kernels, phase_lowp_kernels, phase_int8_kernels,
                  phase_device_alone):
        results.update(phase(dev))
        _clock(t0, phase.__name__)
    phase_golden(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = {}
        launches["serial"], phantom, r2, seg_r2 = phase_slice(dev, tmp)
        _clock(t0, "phase_slice")
        launches["hop"] = phase_hop_slice(dev, phantom, r2, seg_r2, tmp)
        _clock(t0, "phase_hop_slice")
        phase_gate_reference(dev, r2, tmp)
        launches.update(phase_fused_slice(dev, tmp))
        _clock(t0, "phase_fused_slice")
        phase_fused_golden(dev, tmp)
        phase_fused_r2_reference(dev, tmp)
        _clock(t0, "phases 7, 9, 10 (goldens)")
        launches["train"] = phase_train(dev, tmp)
        launches["train_host"] = phase_train_host(dev, tmp)
        launches.update(phase_train_lowp(dev, tmp))
        _clock(t0, "phases 11, 15, 17 (training)")
        launches["round"] = phase_round_slice(dev, phantom, r2, seg_r2, tmp)
        phase_round_golden(dev, r2, tmp)
        _clock(t0, "phases 12, 13 (round)")
        bf16_launches, fused_f32_seeds = phase_bf16_slices(dev, phantom, r2,
                                                           tmp)
        launches.update(bf16_launches)
        _clock(t0, "phase_bf16_slices")
        launches.update(phase_bf16_seed_slice(dev, phantom, r2,
                                              fused_f32_seeds, tmp))
        _clock(t0, "phase_bf16_seed_slice")
        launches.update(phase_int8_slices(dev, phantom, r2, tmp))
        _clock(t0, "phase_int8_slices")
        remaining, remaining_launches = phase_remaining_programs(dev)
        results.update(remaining)
        launches.update(remaining_launches)
        _clock(t0, "phase_remaining_programs")
    # K1 runs on every path: its error is the largest of all phases', its
    # time the 32->32 layer's at N=1 (the serial path's shape).
    results["conv3d_ndhwc_f32"]["max_abs_err"] = max(
        results["conv3d_ndhwc_f32"]["max_abs_err"],
        results.pop("conv3d_ndhwc_f32@hop"))
    results.pop("hop_pop@seg")   # printed; K4's entry is the hop slice's

    # Each kernel's source in ffn_tpu_torch/csrc and the TPU program it
    # replaces in ffn_tpu.
    sources = {name: (f"ffn_tpu_torch/csrc/{src}", f"ffn_tpu/{rep}")
               for name, src, rep in [
        ("conv3d_ndhwc_f32", "conv3d.cu", "models/convstack_3d.py:48"),
        ("conv3d_ndhwc_bf16", "conv3d_bf16.cu", "models/convstack_3d.py:49"),
        ("step_gather", "step.cu", "inference/engine.py:121"),
        ("step_update", "step.cu", "inference/engine.py:88"),
        ("step_gather_bf16", "step.cu", "inference/engine.py:121"),
        ("step_update_bf16", "step.cu", "inference/engine.py:88"),
        ("hop_pop", "hop.cu", "inference/hop_engine.py:553"),
        ("hop_gather", "hop.cu", "inference/hop_engine.py:923"),
        ("hop_update", "hop.cu", "inference/hop_engine.py:976"),
        ("hop_screen", "hop.cu", "inference/hop_engine.py:1156"),
        ("lane_threshold", "lane.cu", "inference/hop_engine.py:1209"),
        ("lane_masks", "lane.cu", "inference/engine.py:489"),
        ("hop_pop_bf16", "hop.cu", "inference/hop_engine.py:553"),
        ("hop_gather_bf16", "hop.cu", "inference/hop_engine.py:923"),
        ("hop_update_bf16", "hop.cu", "inference/hop_engine.py:976"),
        ("lane_threshold_bf16", "lane.cu", "inference/hop_engine.py:1209"),
        ("finalize_pass", "finalize.cu", "inference/hop_engine.py:624"),
        ("finalize_pass_bf16", "finalize.cu", "inference/hop_engine.py:624"),
        ("conv3d_dgrad_f32", "conv3d_bwd.cu", "training/train_lib.py:368"),
        ("conv3d_wgrad_f32", "conv3d_bwd.cu", "training/train_lib.py:368"),
        ("conv3d_ndhwc_f16", "conv3d_bf16.cu", "models/convstack_3d.py:49"),
        ("conv3d_dgrad_bf16", "conv3d_bwd16.cu", "training/train_lib.py:368"),
        ("conv3d_dgrad_f16", "conv3d_bwd16.cu", "training/train_lib.py:368"),
        ("conv3d_wgrad_bf16", "conv3d_bwd16.cu", "training/train_lib.py:368"),
        ("conv3d_wgrad_f16", "conv3d_bwd16.cu", "training/train_lib.py:368"),
        ("conv3d_wgrad1_bf16", "wgrad.cuh", "training/train_lib.py:368"),
        ("conv3d_wgrad1_f16", "wgrad.cuh", "training/train_lib.py:368"),
        ("optim_update_scaled", "optim.cu", "training/precision.py:74"),
        ("train_prep", "train.cu", "training/train_lib.py:239"),
        ("train_gather", "train.cu", "training/train_lib.py:341"),
        ("train_loss", "train.cu", "training/train_lib.py:357"),
        ("train_eval", "train.cu", "training/train_lib.py:255"),
        ("optim_update", "optim.cu", "training/train_lib.py:370"),
        ("fov_loss", "train.cu", "training/train_lib.py:425"),
        ("select_gather", "select.cu", "inference/engine.py:211"),
        ("select_update", "select.cu", "inference/engine.py:266"),
        ("select_gather_bf16", "select.cu", "inference/engine.py:211"),
        ("select_update_bf16", "select.cu", "inference/engine.py:266"),
        ("qconv3d_s8", "qconv3d.cu", "ops/quantized.py:81"),
        ("act_absmax", "qconv3d.cu", "ops/quantized.py:73"),
        ("layernorm_channels", "layernorm.cu", "models/convstack_3d.py:105"),
        ("edges_sobel", "edges.cu", "ops/image.py:81"),
        ("edges_blur", "edges.cu", "ops/image.py:90")]}
    # `launches` sums the main paths' runs; `launches_by_path` splits them
    # (fused and fused_host: the full-width fused slice with device and
    # with host finalization; train: the full-width training run;
    # train_host: the host-loop trainer's run; round: the round-based slice
    # at 8 lanes; *_bf16: the serial, hop, round and fused slices in
    # bfloat16; *_bf16_seeds: phase 16's bf16-seed slices on kernels;
    # train_bf16, train_f16, train_host_bf16: phase 17's training runs;
    # resconv: phase 19's ResConvStack forwards at N=64 in float32 and
    # bfloat16; edges: edges() on the 250^3 demo volume).
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(p.get(name, 0) for p in launches.values()),
                    launches_by_path={path: p.get(name, 0)
                                      for path, p in launches.items()},
                    **results[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
