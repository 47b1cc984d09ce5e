"""ffn_tpu_torch's fused driver (plain path) against the JAX package's
MultiSubvolumeHopDriver on make_setup's volume with the oracle: 8 lanes,
2 slots, 4 hops, both finalize modes, two and four subvolumes (slots
reload); every segmentation, id, origin, count counter and the round
statistics identical. The JAX driver's pools run synchronously (its slot
order otherwise depends on thread timing).
"""

from concurrent.futures import Future
from unittest import mock

import numpy as np
import pytest
import torch

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.inference.counters import Counters
from ffn_tpu.parallel import multi_canvas as jax_multi_canvas
from ffn_tpu.utils import bounding_box as jax_bounding_box
from ffn_tpu_torch.inference import runner
from ffn_tpu_torch.parallel import multi_canvas
from test_sharded_inference import make_setup

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

CONFIGS = {   # name -> (device_finalize, subvolume x size)
    "devfin": (True, 40), "host": (False, 40),
    "devfin_reload": (True, 24), "host_reload": (False, 24)}
STATS = ("rounds", "executed", "lane_rounds", "running_lane_rounds", "pops",
         "max_lane_pops", "fifo_loaded", "fifo_consumed", "wm_mult",
         "screen_calls", "screen_cands", "force_dispatches")


class SyncPool:
    """A ThreadPoolExecutor stand-in that runs each task at submit."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:   # handed to the caller, as a pool does
            fut.set_exception(e)
        return fut


def synchronous_jax_pools():
    return mock.patch.object(jax_multi_canvas, "ThreadPoolExecutor",
                             SyncPool)


def _tasks(outer, size_x):
    calc = jax_bounding_box.OrderlyOverlappingCalculator(
        outer, [size_x, 36, 36], [8, 0, 0])
    return [(tuple(int(v) for v in calc.index_to_sub_box(i).start[::-1]),
             tuple(int(v) for v in calc.index_to_sub_box(i).size[::-1]))
            for i in range(calc.num_sub_boxes())]


def _counts(encoded):
    """A saved counters entry, a TaskCounters proto in both packages (read
    by the JAX package's reader), without the timers."""
    counters = Counters()
    counters.loads(encoded)
    return {k: c.value for k, c in counters if not k.endswith("-ms")}


def _outputs(out_dir, tasks, driver, saved):
    """What a run leaves: per subvolume (segmentation, origins, counts)."""
    subvolumes = []
    for corner, _ in tasks:
        seg, origins = jax_storage.load_segmentation(out_dir, corner,
                                                     split_cc=False)
        with np.load(jax_storage.segmentation_path(out_dir, corner),
                     allow_pickle=True) as data:
            counts = _counts(data["counters"])
        subvolumes.append((seg, {k: (tuple(int(x) for x in o.start_zyx),
                                     int(o.iters))
                                 for k, o in origins.items()}, counts))
    stats = {k: driver.stats.get(k) for k in STATS}
    return saved, subvolumes, stats


def _run(side, tmp, name):
    devfin, size_x = CONFIGS[name]
    request, outer = make_setup(tmp)
    request.concurrent_requests = 8
    request.segmentation_output_dir = str(tmp / side)
    tasks = _tasks(outer, size_x)
    if side == "jax":
        r = jax_runner.Runner()
        r.start(request)
        with synchronous_jax_pools():
            driver = jax_multi_canvas.MultiSubvolumeHopDriver(
                r, tasks, lanes=8, slots=2, hops=4, device_finalize=devfin)
            saved = driver.run()
    else:
        r = runner.Runner(device="cpu")
        r.start(request)
        driver = multi_canvas.MultiSubvolumeHopDriver(
            r, tasks, lanes=8, slots=2, hops=4, device_finalize=devfin)
        saved = driver.run()
    return _outputs(str(tmp / side), tasks, driver, saved), (r, tasks)


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    """The JAX driver's outputs, one run per configuration."""
    return {name: _run("jax", tmp_path_factory.mktemp(name), name)[0]
            for name in CONFIGS}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_driver_matches_jax(jax_fused, tmp_path, name):
    (saved, subvolumes, stats), (r, tasks) = _run("torch", tmp_path, name)
    want_saved, want_subvolumes, want_stats = jax_fused[name]
    assert saved == want_saved == len(tasks) >= 2
    if name.endswith("reload"):
        assert len(tasks) > 2   # more subvolumes than slots
    for (seg, origins, counts), (wseg, worigins, wcounts) in zip(
            subvolumes, want_subvolumes):
        np.testing.assert_array_equal(seg, wseg)
        assert origins == worigins and origins
        assert counts == wcounts
    assert stats == want_stats
    # Idempotent: a second driver over the same outputs saves nothing.
    again = multi_canvas.MultiSubvolumeHopDriver(r, tasks, lanes=8, slots=2,
                                                 hops=4)
    assert again.run() == 0


def test_fused_driver_refuses_a_mesh(tmp_path):
    request, outer = make_setup(tmp_path)
    request.concurrent_requests = 8
    r = runner.Runner(device="cpu")
    r.start(request)
    with pytest.raises(NotImplementedError, match="mesh"):
        multi_canvas.MultiSubvolumeHopDriver(r, _tasks(outer, 40), lanes=8,
                                             mesh=object())
