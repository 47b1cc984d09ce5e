"""ffn_tpu_torch's Runner on the hop path (4 and 64 lanes, host
finalization) against the JAX Runner on test_torch_runner.py's 48^3
phantom with the CI checkpoint: every decision agrees, so segmentations
(ids included), origins and count counters are identical.
"""

import numpy as np
import pytest
import torch

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu_torch.inference import hop_canvas, hop_engine, runner
from test_torch_runner import PAD, SIZE, _request

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def _counts(counters):
    return {name: c.value for name, c in counters if not name.endswith("-ms")}


@pytest.mark.parametrize("lanes", [4, 64])
def test_hop_runner_matches_jax_runner(tmp_path, lanes):
    """At 64 lanes the six cells leave most lanes idle, so relaxed deferral
    floods deferred seeds speculatively: both packages make the same
    duplicate moves (many times the serial run's) and the same drops."""
    box = (SIZE + 2 * PAD,) * 3
    request, _ = _request(tmp_path, tmp_path / "jax")
    request.concurrent_requests = lanes
    want = jax_runner.Runner()
    want.start(request)
    want_canvas = want.run((0, 0, 0), box, keep_probability_maps=False)

    request.segmentation_output_dir = str(tmp_path / "torch")
    got = runner.Runner(device="cpu")
    got.start(request)
    got_canvas = got.run((0, 0, 0), box, keep_probability_maps=False)

    assert isinstance(got_canvas, hop_canvas.HopBatchCanvas)
    assert isinstance(got.engine, hop_engine.HopEngine)
    assert got_canvas.lanes == want_canvas.lanes and got_canvas.hops == 16
    np.testing.assert_array_equal(got_canvas.segmentation,
                                  want_canvas.segmentation)
    assert {k: (tuple(v.start_zyx), v.iters)
            for k, v in got_canvas.origins.items()} == \
        {k: (tuple(v.start_zyx), v.iters)
         for k, v in want_canvas.origins.items()}
    assert _counts(got.counters) == _counts(want.counters)
    assert got.counters["fov-moves"].value > 0
    if lanes == 64:
        assert got.counters["relaxed-deferral-seeds"].value > 0

    # The same seg-0_0_0.npz, through the JAX package's reader.
    for side in ("jax", "torch"):
        seg, _ = jax_storage.load_segmentation(str(tmp_path / side),
                                               (0, 0, 0), split_cc=False)
        np.testing.assert_array_equal(seg, np.maximum(
            want_canvas.segmentation, 0).astype(np.uint64))
