#!/usr/bin/env python3
"""Writes tests/golden/train_ci_golden.npz: two packed scan train steps of
the JAX package on the CPU (~1 min), which chip_smoke.py holds the port's
training to on the card.

  python tests/make_torch_train_golden.py

The CI checkpoint's ConvStack (model-ci-tiny.npz: depth 2, 16 features,
17^3) from its weights, deltas 4 (25^3 canvas, 27 offsets), batch 4,
float32, sgd and adam at lr 0.001 (adam's epsilon 1e-3, so a
near-cancelling gradient entry is not scaled to a full step), on 25^3
crops of a 64^3 phantom (seed 0, 6 cells) centred on foreground. Keys:
image_u8, lom_u8 (2, 4, 25, 25, 25, 1); offsets; init/<name>; per
optimizer <opt>/<metric> (2, 27) or (2,) and <opt>/final/<name>.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ffn_tpu.models import convstack_3d  # noqa: E402
from ffn_tpu.models import params_io  # noqa: E402
from ffn_tpu.training import inputs  # noqa: E402
from ffn_tpu.training import optimizer as optimizer_lib  # noqa: E402
from ffn_tpu.training import precision  # noqa: E402
from ffn_tpu.training import train_lib  # noqa: E402
from make_torch_gate_golden import save_golden  # noqa: E402
from tools import synthetic_em  # noqa: E402

CKPT = os.path.join(REPO, "models", "phantom", "model-ci-tiny.npz")
OUT = os.path.join(REPO, "tests", "golden", "train_ci_golden.npz")
MODEL = dict(fov_size=[17, 17, 17], deltas=[4, 4, 4], depth=2, features=16)
B, STEPS, CANVAS = 4, 2, 25
OPTIMIZERS = ("sgd", "adam")
LR = 0.001
EPS = 1e-3   # adam's epsilon (sgd has none)
METRICS = ("loss", "active", "correct", "missed", "spurious")
EVAL = ("patch_loss", "tp", "fp", "fn", "tn")


def examples():
    """(image_u8, lom_u8), each (STEPS, B, 25, 25, 25, 1) uint8."""
    image, labels = synthetic_em.make_volume(size=64, seed=0, num_cells=6)
    rng = np.random.RandomState(0)
    half = CANVAS // 2
    inner = labels[half:-half, half:-half, half:-half]
    fg = np.argwhere(inner > 0) + half
    picks = fg[rng.choice(len(fg), STEPS * B, replace=False)]
    imgs, loms = [], []
    for z, y, x in picks:
        box = (slice(z - half, z + half + 1), slice(y - half, y + half + 1),
               slice(x - half, x + half + 1))
        imgs.append(image[box])
        loms.append(inputs.center_lom(labels[box]))
    shape = (STEPS, B, CANVAS, CANVAS, CANVAS, 1)
    return (np.asarray(imgs, np.uint8).reshape(shape),
            np.asarray(loms, np.uint8).reshape(shape))


def main():
    image_u8, lom_u8 = examples()
    model = convstack_3d.ConvStack3DFFNModel(**MODEL)
    init = params_io.load_params_npz(CKPT)
    offsets = train_lib.fixed_offsets_zyx(model.info)
    out = dict(image_u8=image_u8, lom_u8=lom_u8, offsets=offsets)
    out.update({f"init/{k}": v for k, v in params_io._flatten(init).items()})
    for opt in OPTIMIZERS:
        config = train_lib.TrainConfig(
            fov_size=(17, 17, 17), deltas=(4, 4, 4), depth=2, features=16,
            batch_size=B, optimizer=optimizer_lib.OptimizerConfig(
                optimizer=opt, learning_rate=LR, epsilon=EPS))
        tx = optimizer_lib.optimizer_from_config(config.optimizer)
        params = jax.tree.map(jnp.asarray, init)
        opt_state = tx.init(params)
        step = train_lib.make_scan_train_step_packed(model, tx, config)
        rows = {k: [] for k in METRICS + EVAL}
        for s in range(STEPS):
            params, opt_state, _, _, m = step(
                params, opt_state, None, precision.NoOpLossScale(),
                jnp.asarray(image_u8[s]), jnp.asarray(lom_u8[s]),
                jnp.asarray(offsets))
            for k in rows:
                rows[k].append(np.asarray(m[k]))
        for k, v in rows.items():
            out[f"{opt}/{k}"] = np.stack(v)
        out.update({f"{opt}/final/{k}": v for k, v in params_io._flatten(
            jax.tree.map(np.asarray, params)).items()})
        print(opt, "active per step", out[f"{opt}/active"].sum(axis=1),
              "loss", out[f"{opt}/loss"][:, 0],
              "patch_loss", out[f"{opt}/patch_loss"])
    save_golden(OUT, out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
