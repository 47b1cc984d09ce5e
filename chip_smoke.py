#!/usr/bin/env python3
"""Drives ffn_tpu_torch's serial inference path once on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit, torch/CUDA versions, and
     which of protobuf/absl/h5py/jax this machine has;
  2. build: the CUDA kernels K1-K3 from ffn_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (K1 within 1e-4 of max|plain| per layer; K2 and K3 bit for bit),
     with median CUDA-event times per call of kernel and plain version,
     timed in turns;
  4. the full-width depth-12 fib25 model on the kernel path against the
     JAX package's stored logits (tests/golden, atol 2e-4);
  5. the slice: Runner -> Canvas -> engine step -> ConvStack3D on the
     repo's padded 100^3 quality-gate phantom with
     configs/inference_phantom.pbtxt's settings, counting kernel launches;
     the same slice on the plain versions; and once more with the
     flagship phantom checkpoint, held to the quality gate's 0.95.
The line before the last is {"kernels": [...]}; the last line is
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
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import step as step_ops

    gen = torch.Generator().manual_seed(0)
    fov = (33, 33, 33)
    results = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    k1 = []
    for name, (k, cin, cout, pre, post, res) in {
            "2->32 post_relu": (3, 2, 32, False, True, False),
            "32->32 pre+post_relu": (3, 32, 32, True, True, False),
            "32->32 +residual": (3, 32, 32, False, False, True),
            "32->1 k=1 pre_relu +residual": (1, 32, 1, True, False, True),
    }.items():
        x = randn(1, *fov, cin)
        w = randn(k, k, k, cin, cout, scale=(2.0 / (k ** 3 * cin)) ** 0.5)
        b = randn(cout, scale=0.1)
        r = randn(1, *fov, cout) if res else None
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        got = conv3d.conv3d_ndhwc_f32(x, w, b, **kw)
        want = conv3d.conv3d_ndhwc_plain(x, w, b, **kw)
        err = float((got - want).abs().max())
        bound = 1e-4 * float(want.abs().max())
        ms, plain_ms = time_pair(
            lambda: conv3d.conv3d_ndhwc_f32(x, w, b, **kw),
            lambda: conv3d.conv3d_ndhwc_plain(x, w, b, **kw))
        print(f"K1 conv3d_ndhwc_f32 {name}: max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} "
              f"ms")
        require(err <= bound, f"K1 {name}: error {err} above {bound}")
        k1.append((name, err, ms, plain_ms))
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


def phase_slice(have, dev):
    from ffn_tpu_torch import _build
    from ffn_tpu_torch.models import convstack_3d
    from ffn_tpu_torch.ops import conv3d
    from ffn_tpu_torch.ops import step as step_ops
    sys.path.insert(0, REPO)
    from tools import synthetic_em

    # The repo's padded 100^3 quality-gate phantom (tools/quality_eval.py,
    # Q_SIZE=100 Q_PAD_IMAGE=16): 120 cells per 250^3 scaled, seed 0.
    image, gt = synthetic_em.make_volume(size=PHANTOM_SIZE, seed=0,
                                         num_cells=PHANTOM_CELLS)
    raw = np.pad(image, PHANTOM_PAD, mode="reflect")
    box = raw.shape
    inner = (slice(PHANTOM_PAD, -PHANTOM_PAD),) * 3
    print(f"phantom: {PHANTOM_SIZE}^3 with {PHANTOM_CELLS} cells, reflect-"
          f"padded by {PHANTOM_PAD} to {box}")

    with tempfile.TemporaryDirectory() as tmp:
        image_path = os.path.join(tmp, "phantom.npy")
        np.save(image_path, raw)
        settings = _settings(have, image_path, os.path.join(tmp, "kernels"))

        _build.launches.clear()
        seg, _, _ = _run_slice("on kernels", settings, dev, box, gt, inner)
        launches = dict(_build.launches)
        print(f"kernel launches on the main path: {launches}")
        require(seg.any(), "the slice segmented no object")
        for name in ("conv3d_ndhwc_f32", "step_gather", "step_update"):
            require(launches.get(name, 0) > 0,
                    f"kernel {name} was not launched on the main path")

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
                dev, box, gt, inner)
        same = synthetic_em.object_level_agreement(seg, seg_p, min_size=1000)
        print(f"kernels vs plain versions: object agreement {same:.4f}, "
              f"identical voxels {bool(np.array_equal(seg, seg_p))}")

        # The same slice with the flagship phantom checkpoint, held to the
        # repo's quality-gate floor (tests/test_shipped_checkpoint.py).
        _, _, agree = _run_slice(
            "with models/phantom/model-r2.npz on kernels",
            dataclasses.replace(
                settings, segmentation_output_dir=os.path.join(tmp, "r2"),
                model_checkpoint_path=os.path.join(
                    REPO, "models", "phantom", "model-r2.npz")),
            dev, box, gt, inner)
        require(agree >= 0.95, f"model-r2 agreement {agree} below the "
                               f"quality gate's 0.95")
    return launches


def main():
    have = phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = phase_kernels(dev)
    phase_golden(dev)
    launches = phase_slice(have, dev)

    sources = {
        "conv3d_ndhwc_f32": ("ffn_tpu_torch/csrc/conv3d.cu",
                             "ffn_tpu/models/convstack_3d.py:48"),
        "step_gather": ("ffn_tpu_torch/csrc/step.cu",
                        "ffn_tpu/inference/engine.py:121"),
        "step_update": ("ffn_tpu_torch/csrc/step.cu",
                        "ffn_tpu/inference/engine.py:88"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=results[name][0],
                    ms=results[name][1], plain_ms=results[name][2])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
