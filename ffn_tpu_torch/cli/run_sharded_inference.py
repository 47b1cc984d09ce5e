#!/usr/bin/env python3
"""Sharded FFN inference on one device: decomposition, workers, stitching.

Counterpart of ffn_tpu/cli/run_sharded_inference.py with its flags plus
--device, --device_finalize and --max_iters_per_segment (0 = unlimited):

  python -m ffn_tpu_torch.cli.run_sharded_inference \
    --inference_request=@req.pbtxt \
    --bounding_box 'start { x:0 y:0 z:0 } size { x:500 y:500 z:500 }' \
    --subvolume_size 165,165,165 --overlap 48,48,48 \
    --worker_id 0 --num_workers 1 --device cuda
  python -m ffn_tpu_torch.cli.run_sharded_inference ... --mode stitch \
    --output global.npz

Worker mode runs the subvolumes with index % num_workers == worker_id
(finished ones skipped) through the fused driver and prints its stats;
stitch mode builds the global ids and writes `segmentation` to .npz (or
file.h5:dataset with h5py).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ffn_tpu_torch.cli.run_inference import parse_bounding_box, parse_request
from ffn_tpu_torch.parallel import sharded_inference
from ffn_tpu_torch.utils import bounding_box


def _xyz(text):
    v = [int(x) for x in text.split(",")]
    if len(v) != 3:
        raise argparse.ArgumentTypeError(
            f"need 3 comma-separated ints, got {text!r}")
    return v


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inference_request", required=True,
                        help="InferenceRequest as a text proto, or @<path>")
    parser.add_argument("--bounding_box", required=True,
                        help="BoundingBox text proto of the OUTER volume")
    parser.add_argument("--subvolume_size", type=_xyz, default="165,165,165",
                        help="subvolume size, xyz, comma-separated")
    parser.add_argument("--overlap", type=_xyz, default="48,48,48",
                        help="inter-subvolume overlap, xyz, comma-separated")
    parser.add_argument("--worker_id", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--mode", choices=["worker", "stitch"],
                        default="worker")
    parser.add_argument("--fused", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="process this worker's subvolumes concurrently "
                             "in one lane batch (else one at a time)")
    parser.add_argument("--lanes", type=int, default=64,
                        help="concurrent flood-fill lanes (fused)")
    parser.add_argument("--slots", type=int, default=4,
                        help="loaded subvolumes per batch (fused)")
    parser.add_argument("--hops", type=int, default=16,
                        help="FFN moves per device round (fused)")
    parser.add_argument("--device_finalize",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="fused: finalize objects on the device (else on "
                             "the host)")
    parser.add_argument("--max_iters_per_segment", type=int, default=0,
                        help="FFN moves after which an object is finalized "
                             "as it is (0: unlimited)")
    parser.add_argument("--seed_handoff",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="flood origins of finished neighbor subvolumes "
                             "first")
    parser.add_argument("--min_overlap_fraction", type=float, default=0.5,
                        help="stitch: the fraction of a segment's overlap "
                             "voxels that must map to one partner")
    parser.add_argument("--output", default="",
                        help="stitch: where to write the assembled volume")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    request = parse_request(args.inference_request)
    os.makedirs(request.segmentation_output_dir, exist_ok=True)
    corner, size = parse_bounding_box(args.bounding_box)
    outer = bounding_box.BoundingBox(start=corner[::-1], size=size[::-1])
    driver = sharded_inference.ShardedInferenceDriver(
        request, outer, subvol_size_xyz=args.subvolume_size,
        overlap_xyz=args.overlap, seed_handoff=args.seed_handoff,
        device=args.device, canvas_defaults=dict(
            max_iters_per_segment=args.max_iters_per_segment))
    n = driver.num_subvolumes()

    if args.mode == "worker":
        start = time.time()
        if args.fused:
            done = driver.run_worker_fused(
                worker_id=args.worker_id, num_workers=args.num_workers,
                lanes=args.lanes, slots=args.slots, hops=args.hops,
                device_finalize=args.device_finalize)
        else:
            done = driver.run_worker(worker_id=args.worker_id,
                                     num_workers=args.num_workers)
        wall = time.time() - start
        print(f"worker {args.worker_id}/{args.num_workers}: {done} "
              f"subvolumes saved ({n} total) in {wall:.1f} s")
        stats = getattr(driver, "fused_stats", None) or {}
        print(json.dumps({"worker": args.worker_id, "saved": done,
                          "subvolumes": n, "wall_s": wall,
                          "stats": {k: v for k, v in stats.items()
                                    if k != "round_times"}}))
        return

    pending = driver.pending_indices()
    if pending:
        raise SystemExit(
            f"stitch: {len(pending)}/{n} subvolumes not finished yet "
            f"(first pending index: {pending[0]})")
    start = time.time()
    stitcher = driver.stitch(min_overlap_fraction=args.min_overlap_fraction)
    if not args.output:
        print(f"stitch: ID space built over {n} subvolumes in "
              f"{time.time() - start:.1f} s")
        return
    out = stitcher.assemble(None)
    if ".h5:" in args.output or args.output.endswith(".h5"):
        import h5py
        path, _, dset = args.output.partition(":")
        with h5py.File(path, "a") as f:
            if (dset or "segmentation") in f:
                del f[dset or "segmentation"]
            f.create_dataset(dset or "segmentation", data=out,
                             compression="gzip")
    else:
        with open(args.output, "wb") as fd:
            np.savez_compressed(fd, segmentation=out)
    print(f"stitch: assembled {out.shape} volume with "
          f"{len(np.unique(out)) - 1} objects in {time.time() - start:.1f} s "
          f"-> {args.output}")


if __name__ == "__main__":
    main()
