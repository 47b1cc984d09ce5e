#!/usr/bin/env python3
"""Writes tests/golden/gate_ci_lanes_golden.npz: the JAX package's
quality-gate pair (tools/quality_eval.py's check 2) with the CI checkpoint,
float32, on the CPU (~24 min): the seed-11 100^3 phantom (8 cells,
reflect-padded by 16) serially, at 64 lanes on the hop path (16 hops) and
at 64 lanes round-based (hops 0). chip_smoke.py holds the port to it.

  python tests/make_torch_gate_golden.py

Keys: the padded image and ground truth; per run R in (1, 64, 64_round)
seg{R}, origins{R} (id, z, y, x, iterations), moves{R}; rounds64_round.
"""

import io
import os
import sys
import tempfile
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.update(Q_DEPTH="2", Q_FOV="17", Q_DELTAS="6", Q_FEATURES="16")

import h5py  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ffn_tpu.inference import runner as runner_lib  # noqa: E402
from tools import quality_eval, synthetic_em  # noqa: E402

CKPT = os.path.join(REPO, "models", "phantom", "model-ci-tiny.npz")
OUT = os.path.join(REPO, "tests", "golden", "gate_ci_lanes_golden.npz")
SIZE, SEED, CELLS, PAD, MAX_ITERS = 100, 11, 8, 16, 4000


def save_golden(path, arrays):
    """np.savez with LZMA members: np.load reads them, ~35% below
    savez_compressed on these phantoms (the repo's size budget)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_LZMA) as z:
        for name, value in arrays.items():
            buf = io.BytesIO()
            np.save(buf, np.asanyarray(value))
            z.writestr(name + ".npy", buf.getvalue())


def main():
    image, gt = synthetic_em.make_volume(size=SIZE, seed=SEED,
                                         num_cells=CELLS)
    raw = np.pad(image, PAD, mode="reflect")
    golden = dict(image=raw, gt=gt)
    with tempfile.TemporaryDirectory() as tmp:
        vol = os.path.join(tmp, "gate.h5")
        with h5py.File(vol, "w") as f:
            f.create_dataset("raw", data=raw)
        for lanes, hops, run in ((1, 16, "1"), (64, 16, "64"),
                                 (64, 0, "64_round")):
            request = quality_eval.build_request(
                vol, os.path.join(tmp, f"l{run}"), CKPT, lanes, "f32")
            runner = runner_lib.Runner()
            runner.canvas_defaults.update(max_iters_per_segment=MAX_ITERS,
                                          hops=hops)
            runner.start(request)
            canvas = runner.run((0, 0, 0), raw.shape,
                                keep_probability_maps=False)
            seg = np.maximum(canvas.segmentation, 0)
            golden[f"seg{run}"] = seg.astype(np.min_scalar_type(seg.max()))
            golden[f"origins{run}"] = np.array(
                [(k, *o.start_zyx, o.iters)
                 for k, o in sorted(canvas.origins.items())], np.int64)
            golden[f"moves{run}"] = runner.counters[
                "fov-moves" if lanes > 1 else "update_at-calls"].value
            if hops == 0:
                golden[f"rounds{run}"] = runner.counters[
                    "predict-calls"].value
            print(f"{run}: {golden[f'moves{run}']} moves, "
                  f"{len(canvas.origins)} origins", flush=True)
    save_golden(OUT, golden)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
