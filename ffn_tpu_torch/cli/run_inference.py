#!/usr/bin/env python3
"""Runs FFN inference in a dense box on one device;
ffn_tpu/cli/run_inference.py's flags plus --device:

  python -m ffn_tpu_torch.cli.run_inference \
    --inference_request="$(cat configs/inference_phantom.pbtxt)" \
    --bounding_box 'start { x:0 y:0 z:0 } size { x:250 y:250 z:250 }' \
    --device cuda

Text protos (or @path); writes seg-X_Y_Z.npz, .prob and counters under
the request's segmentation_output_dir.
"""

from __future__ import annotations

import argparse
import os
import time

from ffn_tpu_torch.inference import runner as runner_lib


def _load(value: str) -> str:
    if value.startswith("@"):
        with open(value[1:]) as f:
            return f.read()
    return value


def parse_request(text: str):
    """InferenceRequest text proto (or @<path>) -> the parsed proto, which
    the Runner keeps to save with the segmentation."""
    from google.protobuf import text_format
    from ffn_tpu_torch.proto import inference_pb2

    request = inference_pb2.InferenceRequest()
    text_format.Parse(_load(text), request)
    return request


def parse_bounding_box(text: str):
    """BoundingBox text proto -> (corner, size), both zyx."""
    from google.protobuf import text_format
    from ffn_tpu_torch.proto import bounding_box_pb2

    box = bounding_box_pb2.BoundingBox()
    text_format.Parse(text, box)
    corner = (box.start.z, box.start.y, box.start.x)
    size = (box.size.z, box.size.y, box.size.x)
    return corner, size


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inference_request", required=True,
                        help="InferenceRequest as a text proto, or @<path>")
    parser.add_argument("--bounding_box", required=True,
                        help="BoundingBox text proto of the area to segment")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    request = parse_request(args.inference_request)
    corner, size = parse_bounding_box(args.bounding_box)

    runner = runner_lib.Runner(device=args.device)
    runner.start(request)
    start_time = time.time()
    runner.run(corner, size)
    print(f"Elapsed: {time.time() - start_time:.1f} s")

    counter_path = os.path.join(request.segmentation_output_dir,
                                "counters.txt")
    if not os.path.exists(counter_path):
        runner.counters.dump(counter_path)


if __name__ == "__main__":
    main()
