"""ffn_tpu_torch's sharded inference (plain path) against the JAX package's
on make_setup's volume with seed handoff: run_worker_fused, run_worker
and the CLI (worker and stitch mode) give the JAX driver's subvolumes,
origins and stitched volume; with one slot the reloaded slot's seed
handoff waits for the (slowed) saves of its neighbour.
"""

import time

import numpy as np
import pytest
import torch

from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.parallel import sharded_inference as jax_sharded
from ffn_tpu_torch.inference import runner as runner_lib
from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.parallel import sharded_inference
from ffn_tpu_torch.parallel import stitching
from ffn_tpu_torch.utils import bounding_box
from test_sharded_inference import make_setup
from test_torch_multi_canvas import synchronous_jax_pools

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


MODES = {   # name -> (fused, slots, subvolume x size, x overlap)
    "fused": (True, 2, 40, 8), "fused_reload": (True, 1, 48, 24),
    "serial": (False, 0, 40, 8)}


def _drivers(tmp, side, mode):
    fused, slots, size_x, overlap_x = MODES[mode]
    request, outer = make_setup(tmp)
    request.concurrent_requests = 8
    request.segmentation_output_dir = str(tmp / side)
    kw = dict(subvol_size_xyz=(size_x, 36, 36),
              overlap_xyz=(overlap_x, 0, 0), seed_handoff=True)
    if side == "jax":
        driver = jax_sharded.ShardedInferenceDriver(request, outer, **kw)
    else:
        driver = sharded_inference.ShardedInferenceDriver(
            request, bounding_box.BoundingBox(start=(0, 0, 0),
                                              size=(72, 36, 36)),
            device="cpu", **kw)
    if fused:
        with synchronous_jax_pools():
            saved = driver.run_worker_fused(lanes=8, slots=slots, hops=4)
    else:
        saved = driver.run_worker(worker_id=0, num_workers=1)
    assert saved == 2 and driver.pending_indices() == []
    return driver, request.segmentation_output_dir


def _subvolumes(driver, out_dir):
    out = []
    for index in range(driver.num_subvolumes()):
        corner = tuple(int(v) for v in
                       driver.calc.index_to_sub_box(index).start[::-1])
        seg, origins = jax_storage.load_segmentation(out_dir, corner,
                                                     split_cc=False)
        out.append((seg, {k: (tuple(int(v) for v in o.start_zyx), o.iters)
                          for k, o in origins.items()}))
    return out


@pytest.fixture(scope="module")
def jax_stitched(tmp_path_factory):
    out = {}
    for mode in MODES:
        driver, out_dir = _drivers(tmp_path_factory.mktemp(mode), "jax",
                                   mode)
        out[mode] = (_subvolumes(driver, out_dir),
                     driver.stitch(min_overlap_fraction=0.5).assemble(None))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_worker_and_stitch_match_jax(jax_stitched, tmp_path, monkeypatch,
                                     mode):
    if mode == "fused_reload":
        save = runner_lib.Runner.save_segmentation

        def slow_save(*args, **kwargs):
            time.sleep(0.5)
            return save(*args, **kwargs)

        monkeypatch.setattr(runner_lib.Runner, "save_segmentation",
                            slow_save)
    driver, out_dir = _drivers(tmp_path, "torch", mode)
    want_subvolumes, want = jax_stitched[mode]
    subvolumes = _subvolumes(driver, out_dir)
    assert len(subvolumes) == len(want_subvolumes) == 2
    for (seg, origins), (wseg, worigins) in zip(subvolumes,
                                                want_subvolumes):
        np.testing.assert_array_equal(seg, wseg)
        assert origins == worigins
    got = driver.stitch(min_overlap_fraction=0.5).assemble(None)
    np.testing.assert_array_equal(got, want)
    bar_left, bar_right = got[18, 18, 12], got[18, 18, 60]
    assert bar_left != 0 and bar_left == bar_right
    cube_l, cube_r = got[8, 8, 8], got[28, 28, 64]
    assert len({int(bar_left), int(cube_l), int(cube_r)}) == 3
    # Idempotent: a rerun saves nothing.
    assert driver.run_worker(worker_id=0, num_workers=1) == 0


def test_cli_worker_and_stitch_on_the_cpu(tmp_path, capsys):
    from ffn_tpu_torch.cli import run_sharded_inference
    request, _ = make_setup(tmp_path)
    text = str(request).replace(str(tmp_path / "seg"),
                                str(tmp_path / "cli"))
    args = [f"--inference_request={text}",
            "--bounding_box=start { x:0 y:0 z:0 } size { x:72 y:36 z:36 }",
            "--subvolume_size=40,36,36", "--overlap=8,0,0", "--lanes=8",
            "--slots=2", "--hops=4", "--device=cpu"]
    with pytest.raises(SystemExit, match="not finished"):
        run_sharded_inference.main(args + ["--mode=stitch"])
    run_sharded_inference.main(args + ["--no-device_finalize"])
    assert "2 subvolumes saved" in capsys.readouterr().out
    out = str(tmp_path / "global.npz")
    run_sharded_inference.main(args + ["--mode=stitch", f"--output={out}"])
    assert "objects" in capsys.readouterr().out
    volume = np.load(out)["segmentation"]
    assert volume.shape == (36, 36, 72)
    assert volume[18, 18, 12] != 0 and volume[18, 18, 12] == \
        volume[18, 18, 60]
    seg, origins = storage.load_segmentation(str(tmp_path / "cli"),
                                             (0, 0, 32), split_cc=False)
    assert seg.shape == (36, 36, 40) and origins


def test_union_find_long_chain():
    uf = stitching.UnionFind()
    n = 50_000   # far beyond Python's recursion limit
    for i in range(n - 1):
        uf.union(i, i + 1)
    assert uf.find(0) == uf.find(n - 1) == uf.find(n // 2)
