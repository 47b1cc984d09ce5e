"""ffn_tpu_torch's HopBatchCanvas with device finalization (K8's plain
version and the round's log; `device_finalize` or FFN_TPU_DEVFIN=1)
against the JAX package's, as test_torch_hop_canvas.py: segmentations,
origins and every count counter identical, stalls included.
"""

import numpy as np
import pytest
import torch

from test_torch_hop_canvas import _counts, _origins, run_jax, run_port

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


@pytest.mark.parametrize("lanes,hops,Q,via_env", [
    (4, 3, 4096, False), (12, 8, 4096, True), (64, 8, 4096, False),
    (4, 8, 16, False)])   # stalls under device finalization: hold, spill
def test_hop_canvas_device_finalize_matches_jax(monkeypatch, lanes, hops, Q,
                                               via_env):
    kwargs = {}
    if via_env:
        monkeypatch.setenv("FFN_TPU_DEVFIN", "1")
    else:
        kwargs["device_finalize"] = True
    want = run_jax(lanes, hops, Q, **kwargs)
    got = run_port(lanes, hops, Q, **kwargs)
    assert got.device_finalize and want.device_finalize
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert _origins(got) == _origins(want) and len(got.origins) >= 2
    assert _counts(got) == _counts(want)
    if Q == 16:
        assert got.counters["queue-stall-drains"].value > 0
