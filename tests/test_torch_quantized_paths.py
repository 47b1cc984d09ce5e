"""ffn_tpu_torch's int8 inference on the batched paths against the JAX
package's, from the same request (test_torch_runner.py's padded 32^3
phantom, the CI checkpoint): the hop path (HopBatchCanvas) at 4 lanes with
precision="int8", and the sharded CLI's fused worker (one subvolume, 4
lanes, host finalization; JAX pools synchronous) with FFN_TPU_PRECISION=int8
against the JAX driver's run_worker_fused. Segmentations, ids, origins and
counters are equal.

Both engines pad a small screen batch to SCREEN_BATCH_SMALL candidates (64);
here 16, the most a 4-lane canvas asks for (2 * 4 + 8), in both packages.
Each lane is quantized with its own scale, so the padding lanes change no
verdict (test_torch_quantized.py shows a lane's logits alone equal them in
a batch); at 64 the JAX package's hop run took 2.7x as long on the CPU
(XLA's int8 dot there is slow).
"""

import numpy as np
import pytest
import torch

from ffn_tpu.inference import hop_engine as jax_hop_engine
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.parallel import sharded_inference as jax_sharded
from ffn_tpu.utils import bounding_box as jax_bounding_box
from ffn_tpu_torch.inference import hop_engine
from test_torch_multi_canvas import _counts as saved_counts
from test_torch_multi_canvas import synchronous_jax_pools
from test_torch_quantized import SIZE, _assert_same, _runs
from test_torch_runner import PAD, _request

torch.set_num_threads(1)


@pytest.fixture
def small_screens(monkeypatch):
    for cls in (jax_hop_engine.HopEngine, hop_engine.HopEngine):
        monkeypatch.setattr(cls, "SCREEN_BATCH_SMALL", 16)


def test_hop_runner_matches_jax(tmp_path, small_screens):
    _assert_same(_runs(tmp_path, 4, {},
                       lambda r, request: r.start(request, precision="int8")))


def test_sharded_cli_fused_worker_matches_jax(tmp_path, monkeypatch,
                                              small_screens):
    from ffn_tpu_torch.cli import run_sharded_inference
    monkeypatch.setenv("FFN_TPU_PRECISION", "int8")
    box = SIZE + 2 * PAD
    request, _ = _request(tmp_path, tmp_path / "jax", size=SIZE)
    driver = jax_sharded.ShardedInferenceDriver(
        request, jax_bounding_box.BoundingBox(start=(0, 0, 0),
                                              size=(box,) * 3),
        subvol_size_xyz=(box,) * 3, overlap_xyz=(0, 0, 0))
    with synchronous_jax_pools():
        assert driver.run_worker_fused(lanes=4, slots=1, hops=16,
                                       device_finalize=False) == 1
    text = str(request).replace(str(tmp_path / "jax"), str(tmp_path / "cli"))
    run_sharded_inference.main([
        f"--inference_request={text}",
        f"--bounding_box=start {{ x:0 y:0 z:0 }} size {{ x:{box} y:{box} "
        f"z:{box} }}", f"--subvolume_size={box},{box},{box}",
        "--overlap=0,0,0", "--lanes=4", "--slots=1", "--hops=16",
        "--no-device_finalize", "--device=cpu"])
    runs = []
    for side in ("jax", "cli"):
        seg, origins = jax_storage.load_segmentation(
            str(tmp_path / side), (0, 0, 0), split_cc=False)
        path = jax_storage.segmentation_path(str(tmp_path / side), (0, 0, 0))
        with np.load(path, allow_pickle=True) as data:
            counts = saved_counts(data["counters"])
        runs.append((seg, {k: (tuple(v.start_zyx), v.iters)
                           for k, v in origins.items()}, counts))
    (wseg, worigins, wcounts), (seg, origins, counts) = runs
    np.testing.assert_array_equal(seg, wseg)
    assert origins == worigins and len(origins) >= 2
    assert counts == wcounts and counts
