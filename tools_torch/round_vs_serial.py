#!/usr/bin/env python3
"""Lanes-vs-serial agreement of the round-based path (hops 0) in both
packages, the CI checkpoint in float32 on the CPU, on the gate's seed-11
phantom of tests/golden/gate_ci_lanes_golden.npz (~10 min):

  JAX_PLATFORMS=cpu python tools_torch/round_vs_serial.py

Adds both packages' 8-lane round runs and the port's serial run to the
golden's JAX runs and prints chip_smoke.py's measure for each pair
(agreement masked to the ground-truth cells, and raw).
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.update(Q_DEPTH="2", Q_FOV="17", Q_DELTAS="6", Q_FEATURES="16")

import h5py  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ffn_tpu.inference import runner as jax_runner  # noqa: E402
from ffn_tpu_torch.inference import runner as torch_runner  # noqa: E402
from tools import quality_eval, synthetic_em  # noqa: E402

CKPT = os.path.join(REPO, "models", "phantom", "model-ci-tiny.npz")
PAD, MAX_ITERS = 16, 4000


def run(make_runner, vol, out, lanes, shape):
    request = quality_eval.build_request(vol, out, CKPT, lanes, "f32")
    runner = make_runner()
    runner.canvas_defaults.update(max_iters_per_segment=MAX_ITERS, hops=0)
    runner.start(request)
    canvas = runner.run((0, 0, 0), shape, keep_probability_maps=False)
    return np.maximum(canvas.segmentation, 0)


def agreement(gt, serial, lanes):
    inner = (slice(PAD, -PAD),) * 3
    a, b = serial[inner].astype(np.uint64), lanes[inner].astype(np.uint64)
    fg = gt > 0
    cells = synthetic_em.object_level_agreement(np.where(fg, a, 0),
                                                np.where(fg, b, 0))
    return cells, synthetic_em.object_level_agreement(a, b)


def main():
    torch.set_num_threads(8)
    ref = np.load(os.path.join(REPO, "tests", "golden",
                               "gate_ci_lanes_golden.npz"))
    image, gt = ref["image"], ref["gt"]
    segs = {"jax serial": ref["seg1"], "jax round 64": ref["seg64_round"]}
    with tempfile.TemporaryDirectory() as tmp:
        vol = os.path.join(tmp, "gate.h5")
        with h5py.File(vol, "w") as f:
            f.create_dataset("raw", data=image)
        for name, make, lanes in (
                ("jax round 8", jax_runner.Runner, 8),
                ("torch round 8",
                 lambda: torch_runner.Runner(device="cpu"), 8),
                ("torch serial",
                 lambda: torch_runner.Runner(device="cpu"), 1)):
            segs[name] = run(make, vol, os.path.join(tmp, name[:3] + name[-1]),
                             lanes, image.shape)
            print(f"{name}: done", flush=True)
    print("torch serial equals jax serial:",
          np.array_equal(segs["torch serial"], segs["jax serial"]))
    for serial, lanes in (("jax serial", "jax round 8"),
                          ("jax serial", "jax round 64"),
                          ("torch serial", "torch round 8")):
        cells, raw = agreement(gt, segs[serial], segs[lanes])
        print(f"{lanes} vs {serial}: cell-restricted agreement "
              f"{cells:.4f}, raw {raw:.4f}")


if __name__ == "__main__":
    main()
