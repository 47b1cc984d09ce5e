#!/usr/bin/env python3
"""Drives ffn_tpu_torch's serial and batched inference paths on one NVIDIA
card.

  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit, torch/CUDA versions, and
     which of protobuf/absl/h5py/jax this machine has;
  2. build: the CUDA kernels K1-K7 from ffn_tpu_torch/csrc with nvcc, one
     process per source;
  3. each kernel against its plain PyTorch version at the main paths'
     shapes (K1 within 1e-4 of max|plain| per layer at N=1, 8, 16, 32, 64
     and 256, and
     for the whole depth-12 stack at N=64; K2-K7 bit for bit), with median
     CUDA-event times per call of kernel and plain version, timed in turns;
     K4-K7 on a crafted 64-lane state on 132^3 that drives every skip kind,
     NaN seeds, fresh, capped and stalling lanes and tied face maxima, and
     K6's screen mode (hop_screen) on a 256-candidate batch; and K1 at N=1
     against the same sample in an N=64 batch, bit for bit (conv compaction
     relies on it);
  4. the full-width depth-12 fib25 model on the kernel path against the
     JAX package's stored logits (tests/golden, atol 2e-4);
  5. the serial slice: Runner -> Canvas -> engine step -> ConvStack3D on
     the repo's padded 100^3 quality-gate phantom with
     configs/inference_phantom.pbtxt's settings, counting kernel launches;
     the same slice on the plain versions; and once more with the
     flagship phantom checkpoint, held to the quality gate's 0.95;
  6. the hop slice: the same request with concurrent_requests 64, hops 16
     and max_iters_per_segment 4000 on the flagship checkpoint, through
     Runner -> HopBatchCanvas -> HopEngine.run_hops, counting launches and
     the device time of each kernel; the same slice with K4-K7 on their
     plain versions (K1 kept) must give the same voxels; it is held to
     ground-truth agreement >= 0.95, and its cell-restricted agreement
     with the serial slice of phase 5 is printed; then the quality gate's
     batched-vs-serial pair (tools/quality_eval.py: the held-out seed-11
     phantom, serial and 8 lanes) is held to 0.95 and 0.99;
  7. the same gate pair at 64 lanes with the CI checkpoint, held voxel for
     voxel, origin for origin and move for move to the JAX package's own
     run of it (tests/golden/gate_ci_lanes_golden.npz); its
     lanes-vs-serial agreement is printed.
The line before the last is {"kernels": [...]}, each kernel's launches
summed over the serial and hop slices' kernel runs and split in
`launches_by_path`; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
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
REPS = 25            # timed runs per kernel and per plain version
LANES = 64           # concurrent_requests of the hop slice (README.md)
HOPS = 16            # FFN_TPU_HOPS' default
MAX_ITERS = 4000     # tools/quality_eval.py's Q_MAX_ITERS
GATE_LANES = 8       # lanes of the batched-vs-serial pair (one per cell)
SCREEN = 256         # HopEngine.SCREEN_BATCH: candidates per screen batch
INIT_ACT = float(np.float32(np.log(0.95 / 0.05)))   # init_activation 0.95


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_pair(kernel_fn, plain_fn, reps=REPS, inner=10):
    """Median ms per call of kernel_fn and plain_fn: `reps` samples of each,
    taken in turns, each timing `inner` back-to-back calls by CUDA events
    (as the calls follow each other in a step)."""
    for fn in (kernel_fn, plain_fn):
        fn()
    times = {kernel_fn: [], plain_fn: []}
    for _ in range(reps):
        for fn in (kernel_fn, plain_fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end) / inner)
    return (statistics.median(times[kernel_fn]),
            statistics.median(times[plain_fn]))


# Every layer kind of the depth-12 stack: (k, Cin, Cout, pre_relu,
# post_relu, residual).
K1_LAYERS = {
    "2->32 post_relu": (3, 2, 32, False, True, False),
    "32->32 pre+post_relu": (3, 32, 32, True, True, False),
    "32->32 +residual": (3, 32, 32, False, False, True),
    "32->1 k=1 pre_relu +residual": (1, 32, 1, True, False, True),
}


def check_k1(randn, n, reps):
    """K1 against its plain version (cuDNN) on N samples of the 33^3 FOV
    for every layer kind, within 1e-4 of max|plain|; times each layer
    with `reps` samples (none if 0). Returns [(name, err, ms, plain_ms)]."""
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
        ms = plain_ms = float("nan")
        if reps:
            ms, plain_ms = time_pair(
                lambda: conv3d.conv3d_ndhwc_f32(x, w, b, **kw),
                lambda: conv3d.conv3d_ndhwc_plain(x, w, b, **kw), reps=reps)
        print(f"K1 conv3d_ndhwc_f32 N={n} {name}: max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} "
              f"ms")
        require(err <= bound, f"K1 N={n} {name}: error {err} above {bound}")
        out.append((name, err, ms, plain_ms))
    return out


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
    from ffn_tpu_torch.ops import step as step_ops

    gen = torch.Generator().manual_seed(0)
    fov = (33, 33, 33)
    results = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    k1 = check_k1(randn, n=1, reps=REPS)
    # The JSON line carries the 32->32 layer's time: 22 of the 24 layers.
    results["conv3d_ndhwc_f32"] = (max(e for _, e, _, _ in k1), k1[1][2],
                                   k1[1][3])

    vol = (PHANTOM_SIZE + 2 * PHANTOM_PAD,) * 3
    image = randn(*vol)
    seed = randn(*vol, scale=3.0)
    seed[randn(*vol) > 0] = float("nan")
    pos = (40, 57, 83)
    pad = float(np.float32(np.log(0.05 / 0.95)))
    got = step_ops.step_gather(image, seed, pos, fov, fov, pad)
    want = step_ops.step_gather_plain(image, seed, pos, fov, fov, pad)
    require(bool(torch.isnan(seed).any()), "K2 input holds no NaN")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K2 step_gather differs from plain: {err}")
    ms, plain_ms = time_pair(
        lambda: step_ops.step_gather(image, seed, pos, fov, fov, pad),
        lambda: step_ops.step_gather_plain(image, seed, pos, fov, fov, pad))
    print(f"K2 step_gather (33^3 of {vol}, NaN seed): bit-exact "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    results["step_gather"] = (err, ms, plain_ms)

    move_t = float(np.float32(np.log(0.9 / 0.1)))
    logits = randn(*fov, scale=3.0)
    frac = float((logits >= move_t).float().mean())
    k3_err = 0.0
    for disco in (-1.0, 0.0, frac + 0.05):
        kseed, pseed = seed.clone(), seed.clone()
        kpatch = step_ops.step_update(logits, kseed, pos, fov, move_t, disco)
        ppatch = step_ops.step_update_plain(logits, pseed, pos, fov, move_t,
                                            disco)
        require(torch.equal(kpatch, ppatch) and torch.equal(
            torch.nan_to_num(kseed, nan=7.0), torch.nan_to_num(pseed,
                                                               nan=7.0)),
                f"K3 step_update differs from plain at disco={disco}")
        k3_err = max(k3_err, float((kpatch - ppatch).abs().max()))
        kept = int((ppatch != logits).sum())
        print(f"K3 step_update disco={disco:.4f} (frac {frac:.4f}): "
              f"bit-exact, {kept} voxels kept their old value")
    ms, plain_ms = time_pair(
        lambda: step_ops.step_update(logits, kseed, pos, fov, move_t, 0.0),
        lambda: step_ops.step_update_plain(logits, pseed, pos, fov, move_t,
                                           0.0))
    print(f"K3 step_update (33^3): kernel {ms:.4f} ms plain {plain_ms:.4f} "
          f"ms")
    results["step_update"] = (k3_err, ms, plain_ms)
    return results


def phase_hop_kernels(dev):
    """K4-K7 against their plain versions on a crafted 64-lane state at the
    hop slice's shapes (132^3 slots, queues of 32768, a 33^3 FOV) and K6's
    screen mode at a 256-candidate screen batch; K1 against its plain
    version at N=64 and N=256 and as the whole stack at N=64; K1 at N=1
    against N=64."""
    from ffn_tpu_torch.models import convstack_3d, params_io
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_kernels as tk

    rng = np.random.RandomState(0)
    vol = (PHANTOM_SIZE + 2 * PHANTOM_PAD,) * 3
    fov, deltas, Q = 33, (8, 8, 8), 32768
    lanes = tk.crafted_lanes(rng, LANES, vol, Q, fov, deltas, MAX_ITERS)
    lanes["image"] = rng.randn(1, *vol).astype(np.float32)
    logits = torch.from_numpy(tk.tied_logits(rng, LANES, fov)).to(dev)
    ks, ps = tk.to_torch(lanes, dev), tk.to_torch(lanes, dev)
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
        same &= all(torch.equal(torch.nan_to_num(ks[k], nan=7.0),
                                torch.nan_to_num(ps[k], nan=7.0))
                    for k in ps)
        require(same, f"K4-K6 differ from their plain versions at hop {hop}")
    counts = {name: int(ps[name].max()) for name in (
        "skip_threshold", "skip_invalid", "skip_restricted")}
    statuses = sorted(set(ps["status"].tolist()))
    print(f"K4 hop_pop + K5 hop_gather + K6 hop_update, 3 hops of "
          f"{LANES} lanes on {vol}: bit-exact; max skips per lane "
          f"{counts}; statuses {statuses}; n_exec {n_exec}")
    require(min(counts.values()) > 16 and 5 in statuses and 4 in statuses,
            "the crafted state missed a skip kind, a stall or a cap")

    seg_t = float(np.float32(np.log(0.6 / 0.4)))
    vkw = dict(segment_threshold=seg_t, move_threshold=tk.MOVE_T)
    got = lane_ops.lane_verdicts(ks["seeds"], ks["sv"], ks["start"],
                                 ks["blocked"], **vkw)
    want = lane_ops.lane_verdicts_plain(ks["seeds"], ks["sv"], ks["start"],
                                        ks["blocked"], **vkw)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "K7 verdicts differ from plain")
    box = ((10, 40, 70), (64, 64, 62), tuple(lanes["start"][5]))
    mkw = dict(threshold=seg_t, move_threshold=tk.MOVE_T)
    got = lane_ops.lane_mask(ks["seeds"], 5, *box, **mkw)
    want = lane_ops.lane_mask_plain(ks["seeds"], 5, *box, **mkw)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "K7 mask differs from plain")
    print(f"K7 lane_threshold: verdicts of {LANES} lanes and a 64^3 mask "
          f"bit-exact ({int(want[0].sum())} voxels set)")

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
    results["hop_pop"] = (0.0,) + time_pair(pop(hop_ops.hop_pop),
                                            pop(hop_ops.hop_pop_plain))
    pos, execute, order, summary = pop(hop_ops.hop_pop)()
    n_exec = int(summary[0])
    gkw = dict(image_size=(fov,) * 3, seed_size=(fov,) * 3, pad=tk.PAD)
    results["hop_gather"] = (0.0,) + time_pair(
        lambda: hop_ops.hop_gather(state["image"], pos, state["sv"], order,
                                   state["seeds"], **gkw),
        lambda: hop_ops.hop_gather_plain(state["image"], pos, state["sv"],
                                         order, state["seeds"], **gkw))

    def update(fn):
        return lambda: fn(
            logits[:n_exec], state["seeds"], pos, execute, order[:n_exec],
            state["start"], state["done"], state["minp"], state["maxp"],
            state["iters"], state["fresh"], state["qpos"], state["qscore"],
            state["head"], state["tail"], state["overflow"],
            pred_size=(fov,) * 3, deltas=deltas, grid_offset=grid_off,
            move_threshold=tk.MOVE_T, disco_threshold=0.0)

    results["hop_update"] = (0.0,) + time_pair(
        update(hop_ops.hop_update), update(hop_ops.hop_update_plain))
    results["lane_threshold"] = (0.0,) + time_pair(
        lambda: lane_ops.lane_verdicts(ks["seeds"], ks["sv"], ks["start"],
                                       ks["blocked"], **vkw),
        lambda: lane_ops.lane_verdicts_plain(ks["seeds"], ks["sv"],
                                             ks["start"], ks["blocked"],
                                             **vkw))
    mask_ms = time_pair(lambda: lane_ops.lane_mask(ks["seeds"], 5, *box,
                                                   **mkw),
                        lambda: lane_ops.lane_mask_plain(ks["seeds"], 5,
                                                         *box, **mkw))
    for name, (_, ms, plain_ms) in results.items():
        print(f"{name} at {LANES} lanes on {vol}: kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms" + (f" ({n_exec} executing lanes)"
                                      if name == "hop_update" else ""))
    print(f"lane_threshold mask (64^3 box): kernel {mask_ms[0]:.4f} ms "
          f"plain {mask_ms[1]:.4f} ms")

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
    results["hop_screen"] = (0.0,) + time_pair(
        lambda: hop_ops.hop_screen(slogits, **ckw),
        lambda: hop_ops.hop_screen_plain(slogits, **ckw))
    print(f"hop_screen at {SCREEN} candidates: kernel "
          f"{results['hop_screen'][1]:.4f} ms plain "
          f"{results['hop_screen'][2]:.4f} ms")
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
    results["conv3d_ndhwc_f32@hop"] = (max([err] + [e for _, e, _, _ in k1]),
                                       k1[1][2], k1[1][3])

    # K1: one sample at N=1 and inside an N=64 batch, bit for bit.
    for i in (0, 17, LANES - 1):
        one = model.apply(img[i:i + 1].contiguous(), sd[i:i + 1].contiguous())
        require(torch.equal(one[0], batch[i]),
                f"K1: sample {i} at N=1 differs from N={LANES}")
    print(f"K1 conv stack (depth 12, 33^3): samples 0, 17, {LANES - 1} at "
          f"N=1 bit-identical to the same samples at N={LANES}")
    return results


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


def _settings(have, image_path, out_dir):
    """configs/inference_phantom.pbtxt's settings, on the phantom."""
    from ffn_tpu_torch.inference import settings as settings_lib
    if have["google.protobuf"]:
        from ffn_tpu_torch.cli.run_inference import parse_request
        settings = parse_request(
            "@" + os.path.join(REPO, "configs", "inference_phantom.pbtxt"))
        print("settings: parsed configs/inference_phantom.pbtxt")
    else:
        settings = settings_lib.InferenceSettings(
            image="", model_name="convstack_3d.ConvStack3DFFNModel",
            segmentation_output_dir="", image_mean=128, image_stddev=33,
            seed_policy="PolicyPeaks", checkpoint_interval=1800,
            model_checkpoint_path="models/phantom/model.ckpt-4000.npz",
            model_args='{"depth": 12, "fov_size": [33, 33, 33], '
                       '"deltas": [8, 8, 8]}',
            inference_options=settings_lib.InferenceOptions(
                init_activation=0.95, pad_value=0.05, move_threshold=0.9,
                segment_threshold=0.6, min_segment_size=1000,
                min_boundary_dist=(1, 1, 1)))
        print("settings: no protobuf here; built the values of "
              "configs/inference_phantom.pbtxt in InferenceSettings")
    return dataclasses.replace(
        settings, image=image_path, segmentation_output_dir=out_dir,
        model_checkpoint_path=os.path.join(REPO,
                                           settings.model_checkpoint_path))


def _run_slice(label, settings, dev, box, gt, inner):
    """One Runner.run over the phantom; prints and returns its numbers."""
    from ffn_tpu_torch.inference import engine as engine_lib
    from ffn_tpu_torch.inference import runner as runner_lib
    from ffn_tpu_torch.inference import storage
    from tools import synthetic_em

    step_s = [0.0]
    step = engine_lib.FloodFillEngine.step

    def timed_step(self, *args):
        # step() returns the patch on the host, so it ends synchronized.
        t = time.perf_counter()
        out = step(self, *args)
        step_s[0] += time.perf_counter() - t
        return out

    runner = runner_lib.Runner(device=dev)
    runner.start(settings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(engine_lib.FloodFillEngine, "step", timed_step):
        runner.run((0, 0, 0), box, keep_probability_maps=False)
    wall = time.perf_counter() - t0
    seg_path = storage.segmentation_path(settings.segmentation_output_dir,
                                         (0, 0, 0))
    require(os.path.exists(seg_path), f"no segmentation at {seg_path}")
    with np.load(seg_path, allow_pickle=True) as data:
        seg = data["segmentation"].astype(np.uint64)[inner]
    steps = runner.counters["update_at-calls"].value
    objects = len(np.unique(seg[seg > 0]))
    agree = synthetic_em.object_level_agreement(gt.astype(np.uint64), seg,
                                                min_size=1000)
    print(f"slice {label}: {steps} FOV steps, {wall:.3f} s wall, "
          f"{steps / wall:.2f} steps/s; engine.step {step_s[0]:.3f} s "
          f"({1e3 * step_s[0] / max(steps, 1):.4f} ms/step), the rest "
          f"{wall - step_s[0]:.3f} s; {objects} objects, ground-truth "
          f"agreement {agree:.4f}")
    return seg, steps, agree


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


def phase_slice(have, dev, tmp):
    """The serial slice; returns (its launches, the phantom, the settings
    with model-r2, and model-r2's serial segmentation)."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import step as step_ops
    from tools import synthetic_em

    image_path, phantom = _phantom(tmp, seed=0)
    settings = _settings(have, image_path, os.path.join(tmp, "kernels"))

    _build.launches.clear()
    seg, _, _ = _run_slice("on kernels", settings, dev, **phantom)
    launches = dict(_build.launches)
    print(f"kernel launches on the serial path: {launches}")
    require(seg.any(), "the slice segmented no object")
    for name in ("conv3d_ndhwc_f32", "step_gather", "step_update"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the serial path")

    with mock.patch.object(convstack_3d, "conv3d_ndhwc_f32",
                           conv3d.conv3d_ndhwc_plain), \
            mock.patch.object(step_ops, "step_gather",
                              step_ops.step_gather_plain), \
            mock.patch.object(step_ops, "step_update",
                              step_ops.step_update_plain):
        seg_p, _, _ = _run_slice(
            "on plain versions", dataclasses.replace(
                settings,
                segmentation_output_dir=os.path.join(tmp, "plain")),
            dev, **phantom)
    same = synthetic_em.object_level_agreement(seg, seg_p, min_size=1000)
    print(f"kernels vs plain versions: object agreement {same:.4f}, "
          f"identical voxels {bool(np.array_equal(seg, seg_p))}")
    require(np.array_equal(seg, seg_p),
            "the serial slice on kernels differs from the plain versions")

    # The same slice with the flagship phantom checkpoint, held to the
    # repo's quality-gate floor (tests/test_shipped_checkpoint.py).
    r2 = dataclasses.replace(
        settings, segmentation_output_dir=os.path.join(tmp, "r2"),
        model_checkpoint_path=os.path.join(REPO, "models", "phantom",
                                           "model-r2.npz"))
    seg_r2, _, agree = _run_slice("with models/phantom/model-r2.npz on "
                                  "kernels", r2, dev, **phantom)
    require(agree >= 0.95, f"model-r2 agreement {agree} below the "
                           f"quality gate's 0.95")
    return launches, phantom, r2, seg_r2


class _HopProbe:
    """Device time of each hop-path call by CUDA events (recorded around
    the call, no synchronization), and the conv batch of each model call."""

    def __init__(self):
        self.events = {}
        self.batches = []     # (N, screening) per model.apply
        self.candidates = 0   # seeds given to screen_seeds
        self._screening = False

    def count(self, screen_seeds):
        def counted(image, positions, *args, **kwargs):
            self.candidates += len(np.asarray(positions).reshape(-1, 3))
            return screen_seeds(image, positions, *args, **kwargs)
        return counted

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


def _run_hop_slice(label, settings, dev, box, gt, inner, probe=None):
    """One Runner.run of the batched request; prints and returns its
    numbers."""
    from ffn_tpu_torch.inference import runner as runner_lib
    from ffn_tpu_torch.inference import storage
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    from tools import synthetic_em

    runner = runner_lib.Runner(device=dev)
    runner.canvas_defaults.update(hops=HOPS, max_iters_per_segment=MAX_ITERS)
    runner.start(settings)
    patches = []
    if probe is not None:
        for mod, name in ((hop_ops, "hop_pop"), (hop_ops, "hop_gather"),
                          (hop_ops, "hop_update"), (hop_ops, "hop_screen"),
                          (lane_ops, "lane_verdicts"),
                          (lane_ops, "lane_mask")):
            patches.append(mock.patch.object(
                mod, name, probe.wrap(name, getattr(mod, name))))
        patches.append(mock.patch.object(
            runner.model, "apply", probe.wrap("model.apply",
                                              runner.model.apply)))
        patches.append(mock.patch.object(
            runner.engine, "screen_seeds",
            probe.count(runner.engine.screen_seeds)))
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
    require(type(canvas).__name__ == "HopBatchCanvas" and
            canvas.lanes <= LANES, f"the hop slice ran {type(canvas)}")
    seg_path = storage.segmentation_path(settings.segmentation_output_dir,
                                         (0, 0, 0))
    with np.load(seg_path, allow_pickle=True) as data:
        seg = data["segmentation"].astype(np.uint64)[inner]
    c = runner.counters
    moves = c["fov-moves"].value
    predict_s = c["predict-time-ms"].value / 1e3
    agree = synthetic_em.object_level_agreement(gt.astype(np.uint64), seg,
                                                min_size=1000)
    print(f"hop slice {label}: {moves} fov-moves in {wall:.3f} s wall, "
          f"{moves / wall:.2f} FOV moves/s; {c['predict-calls'].value} "
          f"rounds; predict (run_hops) {predict_s:.3f} s, the rest "
          f"{wall - predict_s:.3f} s; {len(np.unique(seg[seg > 0]))} "
          f"objects, ground-truth agreement {agree:.4f}; counters "
          f"seed_got_too_weak {c['seed_got_too_weak'].value}, "
          f"screened-weak-seeds {c['screened-weak-seeds'].value}, "
          f"iter-cap-hit {c['iter-cap-hit'].value}, queue-stall-drains "
          f"{c['queue-stall-drains'].value}")
    return seg, moves, wall, agree


def phase_hop_slice(dev, phantom, r2, seg_serial, tmp):
    """The batched request (concurrent_requests 64) on kernels and with
    K4-K7 on their plain versions; returns the kernel run's launches."""
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.ops import hop as hop_ops
    from ffn_tpu_torch.ops import lane as lane_ops
    from tools import synthetic_em

    settings = dataclasses.replace(
        r2, concurrent_requests=LANES,
        segmentation_output_dir=os.path.join(tmp, "hop"))
    probe = _HopProbe()
    _build.launches.clear()
    seg, moves, wall, agree = _run_hop_slice(
        "with model-r2 on kernels", settings, dev, **phantom, probe=probe)
    launches = dict(_build.launches)
    print(f"kernel launches on the hop path: {launches}")
    for name in ("conv3d_ndhwc_f32", "hop_pop", "hop_gather", "hop_update",
                 "hop_screen", "lane_threshold"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the hop path")
    hops = len(probe.events["hop_pop"])
    lane_evals = sum(n for n, _ in probe.batches)
    buckets = [n for n, screen in probe.batches if not screen]
    screens = [n for n, screen in probe.batches if screen]
    ms = probe.device_ms()
    print(f"hops {hops}, mean conv bucket {statistics.mean(buckets):.2f} "
          f"lanes over {len(buckets)} hop convs; screen batches "
          f"{len(screens)} ({sum(screens)} lane-evaluations for "
          f"{probe.candidates} candidates); conv "
          f"lane-evaluations {lane_evals} ({moves / lane_evals:.3f} "
          f"executed moves per lane-evaluation)")
    device = sum(ms.values())
    print("device ms by call (CUDA events): " + ", ".join(
        f"{name} {t:.1f} ({t / hops:.4f}/hop)" for name, t in ms.items())
        + f"; sum {device:.1f} ms of {1e3 * wall:.1f} ms wall: host and "
          f"idle {1e3 * wall - device:.1f} ms")

    with mock.patch.object(hop_ops, "hop_pop", hop_ops.hop_pop_plain), \
            mock.patch.object(hop_ops, "hop_gather",
                              hop_ops.hop_gather_plain), \
            mock.patch.object(hop_ops, "hop_update",
                              hop_ops.hop_update_plain), \
            mock.patch.object(hop_ops, "hop_screen",
                              hop_ops.hop_screen_plain), \
            mock.patch.object(lane_ops, "lane_verdicts",
                              lane_ops.lane_verdicts_plain), \
            mock.patch.object(lane_ops, "lane_mask",
                              lane_ops.lane_mask_plain):
        seg_p, moves_p, _, _ = _run_hop_slice(
            "with model-r2, K4-K7 on plain versions", dataclasses.replace(
                settings, segmentation_output_dir=os.path.join(
                    tmp, "hop_plain")), dev, **phantom)
    require(np.array_equal(seg, seg_p) and moves == moves_p,
            "the hop slice on K4-K7 differs from their plain versions")
    print("hop slice, kernels vs K4-K7 plain: identical voxels, same "
          "fov-moves")

    require(agree >= 0.95, f"hop slice model-r2 agreement {agree} below "
                           f"the quality gate's 0.95")
    # Printed, not required: at 48-64 lanes on these 8-cell phantoms the
    # batched path splits a cell the serial one keeps whole (0.4762 here,
    # 0.8889 on the gate's phantom, NVIDIA H100 80GB HBM3, 700 W), and so
    # does the JAX package: phase_gate_reference holds the port to its
    # 64-lane run, which scores 0.8571.
    _lanes_vs_serial(LANES, "model-r2, the slice's phantom (seed 0)",
                     phantom, seg_serial, seg)

    # The quality gate's batched-vs-serial pair (tools/quality_eval.py
    # :193-219) on its held-out seed-11 phantom, at 8 lanes, where lanes do
    # not outnumber the cells: held to the gate's 0.99.
    path, gate = _phantom(tmp, seed=11)
    gate_r2 = dataclasses.replace(r2, image=path)
    seg_1, _, _ = _run_slice(
        "gate phantom (seed 11), serial, model-r2", dataclasses.replace(
            gate_r2, segmentation_output_dir=os.path.join(tmp, "gate_1")),
        dev, **gate)
    seg_n, _, _, gate_agree = _run_hop_slice(
        f"gate phantom (seed 11), {GATE_LANES} lanes, model-r2",
        dataclasses.replace(gate_r2, concurrent_requests=GATE_LANES,
                            segmentation_output_dir=os.path.join(
                                tmp, "gate_n")), dev, **gate)
    cells = _lanes_vs_serial(GATE_LANES, "model-r2, the gate's phantom",
                             gate, seg_1, seg_n)
    require(gate_agree >= 0.95 and cells >= 0.99,
            f"gate phantom: agreement {gate_agree}, lanes-vs-serial {cells}")
    return launches


def phase_gate_reference(dev, r2, tmp):
    """The quality gate's pair with the CI checkpoint (depth 2, 16
    features, 17^3) against the JAX package's own run of it in float32 on
    a CPU (tests/golden/gate_ci_lanes_golden.npz, written by
    tests/make_torch_gate_golden.py): serial and 64 lanes on kernels must
    give its segmentations voxel for voxel, its origins and its moves. The
    phantom comes from the golden: this machine's numpy may draw it a
    voxel differently."""
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


def main():
    have = phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = phase_kernels(dev)
    results.update(phase_hop_kernels(dev))
    phase_golden(dev)
    with tempfile.TemporaryDirectory() as tmp:
        serial, phantom, r2, seg_r2 = phase_slice(have, dev, tmp)
        hop = phase_hop_slice(dev, phantom, r2, seg_r2, tmp)
        phase_gate_reference(dev, r2, tmp)
    # K1 runs on both paths: its error is the largest of both phases', its
    # time the 32->32 layer's at N=1 (the serial path's shape).
    k1_err = max(results["conv3d_ndhwc_f32"][0],
                 results.pop("conv3d_ndhwc_f32@hop")[0])
    results["conv3d_ndhwc_f32"] = (k1_err,) + results["conv3d_ndhwc_f32"][1:]

    sources = {
        "conv3d_ndhwc_f32": ("ffn_tpu_torch/csrc/conv3d.cu",
                             "ffn_tpu/models/convstack_3d.py:48"),
        "step_gather": ("ffn_tpu_torch/csrc/step.cu",
                        "ffn_tpu/inference/engine.py:121"),
        "step_update": ("ffn_tpu_torch/csrc/step.cu",
                        "ffn_tpu/inference/engine.py:88"),
        "hop_pop": ("ffn_tpu_torch/csrc/hop.cu",
                    "ffn_tpu/inference/hop_engine.py:553"),
        "hop_gather": ("ffn_tpu_torch/csrc/hop.cu",
                       "ffn_tpu/inference/hop_engine.py:923"),
        "hop_update": ("ffn_tpu_torch/csrc/hop.cu",
                       "ffn_tpu/inference/hop_engine.py:976"),
        "hop_screen": ("ffn_tpu_torch/csrc/hop.cu",
                       "ffn_tpu/inference/hop_engine.py:1156"),
        "lane_threshold": ("ffn_tpu_torch/csrc/lane.cu",
                           "ffn_tpu/inference/hop_engine.py:1209"),
    }
    # `launches` sums the two main paths' runs; `launches_by_path` splits
    # them.
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=serial.get(name, 0) + hop.get(name, 0),
                    launches_by_path={"serial": serial.get(name, 0),
                                      "hop": hop.get(name, 0)},
                    max_abs_err=results[name][0],
                    ms=results[name][1], plain_ms=results[name][2])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
