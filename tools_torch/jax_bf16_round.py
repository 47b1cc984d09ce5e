#!/usr/bin/env python3
"""The JAX package's own bfloat16 round slice on the CPU (~50 min on 8
cores): chip_smoke.py's phase-14 configuration (model-r2 in bfloat16, 8
lanes, hops 0, max_iters 4000) on the padded 100^3 phantom of seed 0,
through ffn_tpu's Runner; prints moves, objects and agreement.

  python tools_torch/jax_bf16_round.py [--port] [--ci]

FFN_TPU_SEED_DTYPE=bf16 keeps bf16 lane seeds in both packages. `--port`
runs ffn_tpu_torch's Runner with the JAX model's bf16 convolutions; `--ci`
the CI checkpoint in bf16 (minutes). XLA's CPU backend keeps fused bf16
intermediates in float32 (`xla_allow_excess_precision`), so JAX's outputs
depend on the program; with XLA_FLAGS=--xla_allow_excess_precision=false
they agree.
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import h5py  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from google.protobuf import text_format  # noqa: E402
from ffn_tpu.inference import runner as jax_runner  # noqa: E402
from ffn_tpu.inference import storage as jax_storage  # noqa: E402
from ffn_tpu.proto import inference_pb2  # noqa: E402
from tools import synthetic_em  # noqa: E402

PAD = 16


def main():
    tmp = tempfile.mkdtemp()
    image, gt = synthetic_em.make_volume(size=100, seed=0, num_cells=8)
    raw = np.pad(image, PAD, mode="reflect")
    with h5py.File(os.path.join(tmp, "v.h5"), "w") as f:
        f.create_dataset("raw", data=raw)
    request = inference_pb2.InferenceRequest()
    with open(os.path.join(REPO, "configs", "inference_phantom.pbtxt")) as f:
        text_format.Parse(f.read(), request)
    request.image.hdf5 = os.path.join(tmp, "v.h5") + ":raw"
    request.segmentation_output_dir = os.path.join(tmp, "out")
    request.model_checkpoint_path = os.path.join(
        REPO, "models", "phantom", "model-r2.npz")
    args = json.loads(request.model_args)
    if "--ci" in sys.argv:
        request.model_checkpoint_path = os.path.join(
            REPO, "models", "phantom", "model-ci-tiny.npz")
        args = {"depth": 2, "fov_size": [17] * 3, "deltas": [6] * 3,
                "features": 16}
    args["dtype"] = "bfloat16"
    request.model_args = json.dumps(args)
    request.concurrent_requests = 8
    runner = jax_runner.Runner()
    runner.canvas_defaults.update(hops=0, max_iters_per_segment=4000)
    runner.start(request)
    if "--port" in sys.argv:
        import torch
        from ffn_tpu_torch.inference import runner as torch_runner
        model, params = runner.model, runner.model_params
        runner = torch_runner.Runner(device="cpu")
        runner.canvas_defaults.update(hops=0, max_iters_per_segment=4000)
        runner.start(request)
        runner.model.apply = lambda image, seed: torch.from_numpy(np.array(
            model.apply(params, image.numpy(), seed.numpy()), np.float32))
    t0 = time.time()
    runner.run((0, 0, 0), raw.shape, keep_probability_maps=False)
    seg = jax_storage.load_segmentation(request.segmentation_output_dir,
                                        (0, 0, 0), split_cc=False)[0]
    inner = seg[(slice(PAD, -PAD),) * 3]
    print(json.dumps({
        "wall_s": time.time() - t0,
        "moves": runner.counters["fov-moves"].value,
        "objects": len(np.unique(seg[seg > 0])),
        "agreement": synthetic_em.object_level_agreement(
            gt.astype(np.uint64), inner.astype(np.uint64), min_size=1000)}))


if __name__ == "__main__":
    main()
