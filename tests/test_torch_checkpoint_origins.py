"""Inference checkpoints written by other packages restore in the port: a
checkpoint's pickled `origins` ({id: OriginInfo} of ffn_tpu's or
google/ffn's class) is read through storage's reader by all three
canvases, importing neither writer. The JAX package writes a checkpoint
of each kind; a fresh interpreter without ffn_tpu or jax restores each,
and a serial one pickled under ffn.inference.storage.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
from scipy.special import logit
import torch

from ffn_tpu.inference import batch_canvas as jax_batch_canvas
from ffn_tpu.inference import canvas as jax_canvas
from ffn_tpu.inference import engine as jax_engine
from ffn_tpu.inference import hop_canvas as jax_hop_canvas
from ffn_tpu.inference import hop_engine as jax_hop_engine
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.models import oracle as jax_oracle
from test_canvas_e2e import DELTAS, FOV, make_image, make_options

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_checkpoints(root):
    """A checkpoint of each JAX canvas kind holding object 7 with origin
    ((7, 7, 7), 11 iterations, 0.5 s)."""
    opts = make_options()
    model = jax_oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                            deltas=list(DELTAS))
    kw = dict(pad_value=float(logit(opts.pad_value)),
              move_threshold=float(logit(opts.move_threshold)),
              disco_seed_threshold=opts.disco_seed_threshold)
    serial = jax_engine.FloodFillEngine(model, {}, **kw)
    hops = jax_hop_engine.HopEngine(model, {}, queue_capacity=4096, **kw)
    image = make_image()
    np.save(os.path.join(root, "image.npy"), image)
    canvases = {
        "serial": jax_canvas.Canvas(model.info, serial, image, opts),
        "round": jax_batch_canvas.BatchCanvas(model.info, hops, image, opts,
                                              lanes=4, candidates_per_step=4),
        "hop": jax_hop_canvas.HopBatchCanvas(model.info, hops, image, opts,
                                             lanes=2, hops=3),
    }
    for kind, cv in canvases.items():
        cv.segmentation[6:9, 6:9, 6:9] = 7
        cv.origins = {7: jax_storage.OriginInfo((7, 7, 7), 11, 0.5)}
        cv.overlaps = {7: np.array([[0], [27]])}
        path = os.path.join(root, f"{kind}.npz")
        if kind == "serial":
            cv.save_checkpoint(path, partial_segment_iters=3)
        else:
            cv.save_checkpoint(path)


def _ffn_checkpoint(root):
    """The serial checkpoint with its origins pickled under
    ffn.inference.storage, as google/ffn writes them."""
    code = textwrap.dedent(f"""
        import collections, sys, types
        import numpy as np
        for name in ("ffn", "ffn.inference", "ffn.inference.storage"):
            sys.modules[name] = types.ModuleType(name)
        OriginInfo = collections.namedtuple(
            "OriginInfo", ["start_zyx", "iters", "walltime_sec"])
        OriginInfo.__module__ = "ffn.inference.storage"
        sys.modules["ffn.inference.storage"].OriginInfo = OriginInfo
        with np.load({root!r} + "/serial.npz", allow_pickle=True) as f:
            data = {{k: f[k] for k in f.files}}
        data["origins"] = np.array({{7: OriginInfo((7, 7, 7), 11, 0.5)}},
                                   dtype=object)
        with open({root!r} + "/ffn.npz", "wb") as f:
            np.savez_compressed(f, **data)
        """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def test_foreign_checkpoints_restore_without_their_packages(tmp_path):
    root = str(tmp_path)
    _jax_checkpoints(root)
    _ffn_checkpoint(root)
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from scipy.special import logit
        from ffn_tpu_torch.inference import (batch_canvas, canvas, engine,
                                             hop_canvas, hop_engine, storage)
        from ffn_tpu_torch.inference.settings import InferenceOptions
        from ffn_tpu_torch.models import oracle

        root = {root!r}
        image = np.load(root + "/image.npy")
        options = InferenceOptions(
            init_activation=0.95, pad_value=0.05, move_threshold=0.9,
            segment_threshold=0.6, min_segment_size=5,
            disco_seed_threshold=0.0, min_boundary_dist=(1, 1, 1))
        model = oracle.ThresholdOracleModel(fov_size=[{FOV}] * 3,
                                            deltas={list(DELTAS)})
        kw = dict(pad_value=float(logit(0.05)),
                  move_threshold=float(logit(0.9)), disco_seed_threshold=0.0)
        serial = engine.FloodFillEngine(model, device="cpu", **kw)
        hops = hop_engine.HopEngine(model, queue_capacity=4096, device="cpu",
                                    **kw)
        made = {{
            "serial": lambda: canvas.Canvas(model.info, serial, image,
                                            options),
            "round": lambda: batch_canvas.BatchCanvas(
                model.info, hops, image, options, lanes=4,
                candidates_per_step=4),
            "hop": lambda: hop_canvas.HopBatchCanvas(
                model.info, hops, image, options, lanes=2, hops=3),
        }}
        for name, kind in (("serial", "serial"), ("round", "round"),
                           ("hop", "hop"), ("ffn", "serial")):
            cv = made[kind]()
            cv.restore_checkpoint(root + f"/{{name}}.npz")
            assert list(cv.origins) == [7], (name, cv.origins)
            info = cv.origins[7]
            assert type(info) is storage.OriginInfo, (name, type(info))
            assert tuple(info) == ((7, 7, 7), 11, 0.5), (name, info)
            assert (cv.segmentation == 7).sum() == 27, name
        bad = sorted(m for m in sys.modules if m in ("jax", "ffn")
                     or m.split(".")[0] in ("ffn_tpu", "ffn"))
        assert not bad, bad
        """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
