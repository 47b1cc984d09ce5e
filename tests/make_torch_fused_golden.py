#!/usr/bin/env python3
"""Writes the fused-driver goldens: the JAX package's fused multi-subvolume
driver (run_worker_fused + stitching), float32, on the CPU; chip_smoke.py
holds the port to them on the card.

  python tests/make_torch_fused_golden.py [--model ci|r2]  # ci: minutes;
                                                           # r2: ~30 min

Phantoms reflect-padded by 16, 8 subvolumes, max_iters 4000, seed handoff.
--model ci (fused_ci_golden.npz): the 48^3 phantom of test_torch_runner.py
(seed 3, 6 cells) in 48^3 subvolumes (overlap 16), the CI checkpoint, 16
lanes, 4 slots, 8 hops, both finalize modes, each run twice (held voxel,
origin and counter for counter). --model r2 (fused_r2_golden.npz): a 64^3
phantom (seed 0, 4 cells) in 64^3 subvolumes (overlap 32), model-r2, 64
lanes, 4 slots, 16 hops, device finalization, once: the JAX package's own
stitched agreement (the packages' convolutions round differently).

The driver's pools run synchronously: with real pools the JAX driver's
slot order depends on thread timing (multi_canvas.py:555-568); with every
policy ready it follows the port's order. Keys: image, gt; per mode M
(devfin, host): M_seg (8 subvolumes in index order), M_origins (rows:
subvolume, id, z, y, x, iterations), M_counters (JSON), M_stitched,
M_agreement (object_level_agreement, min_size 1000), M_deterministic (ci).
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import h5py  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ffn_tpu.inference import runner as runner_lib  # noqa: E402
from ffn_tpu.inference import storage  # noqa: E402
from ffn_tpu.parallel import multi_canvas  # noqa: E402
from ffn_tpu.parallel import sharded_inference  # noqa: E402
from ffn_tpu.proto import inference_pb2  # noqa: E402
from ffn_tpu.utils import bounding_box  # noqa: E402
from test_torch_runner import _request  # noqa: E402
from make_torch_gate_golden import save_golden  # noqa: E402
from tools import synthetic_em  # noqa: E402

PAD, MAX_ITERS = 16, 4000
# model -> (output, phantom (size, seed, cells), subvolume, overlap, lanes,
# slots, hops, modes, runs per mode, request overrides: checkpoint,
# model_args, min_segment_size; None keeps test_torch_runner._request's
# CI request).
MODELS = {
    "ci": ("fused_ci_golden.npz", (48, 3, 6), 48, 16, 16, 4, 8,
           ("devfin", "host"), 2, None),
    "r2": ("fused_r2_golden.npz", (64, 0, 4), 64, 32, 64, 4, 16,
           ("devfin",), 1,
           (os.path.join(REPO, "models", "phantom", "model-r2.npz"),
            {"depth": 12, "fov_size": [33] * 3, "deltas": [8] * 3}, 1000)),
}


class SyncPool:
    """A ThreadPoolExecutor stand-in that runs each task at submit."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future
        fut = Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:   # handed to the caller, as a pool does
            fut.set_exception(e)
        return fut


def run(tmp, raw, devfin, tag, model):
    _, _, sub, overlap, lanes, slots, hops, _, _, overrides = MODELS[model]
    request, _ = _request(pathlib.Path(tmp), os.path.join(tmp, tag))
    if overrides:
        ckpt, model_args, min_size = overrides
        request.model_checkpoint_path = ckpt
        request.model_args = json.dumps(model_args)
        request.inference_options.min_segment_size = min_size
    vol = os.path.join(tmp, f"{tag}.h5")
    with h5py.File(vol, "w") as f:
        f.create_dataset("raw", data=raw)
    request.image.hdf5 = f"{vol}:raw"
    edge = raw.shape[0]
    driver = sharded_inference.ShardedInferenceDriver(
        request, bounding_box.BoundingBox(start=(0, 0, 0), size=(edge,) * 3),
        subvol_size_xyz=(sub,) * 3, overlap_xyz=(overlap,) * 3,
        seed_handoff=True)
    runner = runner_lib.Runner()
    runner.canvas_defaults["max_iters_per_segment"] = MAX_ITERS
    runner.start(request)
    saved = driver.run_worker_fused(runner=runner, lanes=lanes, slots=slots,
                                    hops=hops, device_finalize=devfin)
    assert saved == driver.num_subvolumes() == 8, saved
    segs, origins, counters = [], [], []
    for index in range(driver.num_subvolumes()):
        box = driver.calc.index_to_sub_box(index)
        corner = tuple(int(v) for v in box.start[::-1])
        seg, orig = storage.load_segmentation(request.segmentation_output_dir,
                                              corner, split_cc=False)
        segs.append(seg.astype(np.int32))
        origins += [(index, k, *o.start_zyx, o.iters)
                    for k, o in sorted(orig.items())]
        with np.load(storage.segmentation_path(
                request.segmentation_output_dir, corner),
                allow_pickle=True) as data:
            proto = inference_pb2.TaskCounters.FromString(
                bytes(data["counters"]))
        counters.append({c.name: c.value for c in proto.counters
                         if not c.name.endswith("-ms")})
    stitched = driver.stitch(min_overlap_fraction=0.5).assemble(None)
    return (np.stack(segs), np.array(origins, np.int64), counters,
            stitched.astype(np.int32))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--model", choices=list(MODELS), default="ci")
    model = parser.parse_args().model
    name, (size, seed, cells), _, _, _, _, _, modes, repeats, _ = \
        MODELS[model]
    out = os.path.join(REPO, "tests", "golden", name)
    multi_canvas.ThreadPoolExecutor = SyncPool
    image, gt = synthetic_em.make_volume(size=size, seed=seed,
                                         num_cells=cells)
    raw = np.pad(image, PAD, mode="reflect")
    golden = dict(image=raw, gt=gt)
    with tempfile.TemporaryDirectory() as tmp:
        for mode in modes:
            devfin = mode == "devfin"
            runs = [run(tmp, raw, devfin, f"{mode}_{i}", model)
                    for i in range(repeats)]
            seg, origins, counters, stitched = runs[0]
            agree = synthetic_em.object_level_agreement(
                gt.astype(np.uint64),
                stitched[(slice(PAD, -PAD),) * 3].astype(np.uint64),
                min_size=1000)
            golden.update({f"{mode}_seg": seg, f"{mode}_origins": origins,
                           f"{mode}_counters": json.dumps(counters),
                           f"{mode}_stitched": stitched,
                           f"{mode}_agreement": agree})
            same = None
            if repeats > 1:
                same = all(
                    all(np.array_equal(a, b) for a, b in
                        ((runs[0][0], r[0]), (runs[0][1], r[1]),
                         (runs[0][3], r[3]))) and runs[0][2] == r[2]
                    for r in runs[1:])
                golden[f"{mode}_deterministic"] = same
            moves = sum(c.get("fov-moves", 0) for c in counters)
            print(f"{mode}: {moves} moves, {len(origins)} origins, "
                  f"{len(np.unique(stitched)) - 1} stitched objects, "
                  f"ground-truth agreement {agree:.4f}; {repeats} runs "
                  f"identical: {same}", flush=True)
    save_golden(out, golden)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
