#!/usr/bin/env python3
"""Trains an FFN on one card; ffn_tpu/cli/train.py's flags plus --device:

  python -m ffn_tpu_torch.cli.train \
    --train_coords coords.npz \
    --data_volumes 'v:/data/img.npy' --label_volumes 'v:/data/labels.npy' \
    --image_mean 128 --image_stddev 33 --train_dir /tmp/train \
    --max_steps 1000 --device cuda

Volumes are `name:path:dataset` (h5) or `name:path.npy`. The packed scan
trainer, or --trainer host_loop (also max_pred_moves and no_step);
`--device cpu` runs the plain versions; --precision bf16|f16 trains in 16
bits. --remat and multi-process training raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import logging

from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import train_lib
from ffn_tpu_torch.training import train_loop

NOT_PORTED = "is not ported to ffn_tpu_torch yet (ROADMAP.md)"


def _axes(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x.strip())


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    a = p.add_argument
    a("--train_coords", required=True,
      help="Coordinate file (GZIP TFRecord of tf.train.Example, or .npz "
           "with center/label_volume_name).")
    a("--data_volumes", required=True,
      help="Image volumes as <name>:<path>:<dataset> or <name>:<file>.npy")
    a("--label_volumes", required=True,
      help="Label volumes as <name>:<path>:<dataset> or <name>:<file>.npy")
    a("--model_name", default="convstack_3d.ConvStack3DFFNModel")
    a("--model_args", default=None,
      help="JSON dict of model constructor kwargs.")
    a("--train_dir", default="/tmp/ffn_tpu_train")
    a("--batch_size", type=int, default=4)
    a("--max_steps", type=int, default=10000)
    a("--image_mean", type=float, required=True)
    a("--image_stddev", type=float, required=True)
    a("--permutable_axes", type=_axes, default=(1, 2))
    a("--reflectable_axes", type=_axes, default=(0, 1, 2))
    a("--fov_policy", default="fixed",
      choices=["fixed", "max_pred_moves", "no_step", "fixed_window"])
    a("--fov_moves", type=int, default=1)
    a("--fixed_window_radius", type=int, default=8)
    a("--threshold", type=float, default=0.9)
    a("--shuffle_fov_moves", action=argparse.BooleanOptionalAction,
      default=False)
    a("--summary_rate_secs", type=int, default=120, help="(compat; unused)")
    a("--summary_every_steps", type=int, default=100)
    a("--checkpoint_every_steps", type=int, default=1000)
    a("--ema_decay", type=float, default=0.0)
    a("--precision", default="f32", choices=["f32", "bf16", "f16"])
    a("--remat", action=argparse.BooleanOptionalAction, default=False)
    a("--coordinator_address", default=None)
    a("--num_processes", type=int, default=None)
    a("--process_id", type=int, default=None)
    a("--stall_timeout_secs", type=float, default=0.0)
    a("--random_seed", type=int, default=0)
    a("--trainer", default="scan", choices=["scan", "host_loop"])
    a("--optimizer", default="sgd",
      choices=["momentum", "sgd", "adagrad", "adam", "rmsprop"])
    a("--learning_rate", type=float, default=0.001)
    a("--momentum", type=float, default=0.9)
    a("--learning_rate_decay_factor", type=float, default=None)
    a("--decay_steps", type=int, default=None)
    a("--rmsprop_decay", type=float, default=0.9)
    a("--adam_beta1", type=float, default=0.9)
    a("--adam_beta2", type=float, default=0.999)
    a("--epsilon", type=float, default=1e-8)
    a("--device", default="cuda",
      help="cuda (the hand-written kernels) or cpu (their plain versions)")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.coordinator_address or args.num_processes or \
            args.process_id is not None:
        raise NotImplementedError(
            f"multi-process training {NOT_PORTED}: the port trains on one "
            f"card")
    model_args = json.loads(args.model_args) if args.model_args else {}
    config = train_lib.TrainConfig(
        fov_size=tuple(model_args.get("fov_size", (33, 33, 33))),
        deltas=tuple(model_args.get("deltas", (8, 8, 8))),
        depth=model_args.get("depth", 12),
        features=model_args.get("features", 32),
        batch_size=args.batch_size,
        fov_moves=args.fov_moves,
        fov_policy=args.fov_policy,
        fixed_window_radius=args.fixed_window_radius,
        threshold=args.threshold,
        shuffle_fov_moves=args.shuffle_fov_moves,
        ema_decay=args.ema_decay,
        precision=args.precision,
        remat=args.remat,
        image_mean=args.image_mean,
        image_stddev=args.image_stddev,
        optimizer=optimizer_lib.OptimizerConfig(
            optimizer=args.optimizer,
            learning_rate=args.learning_rate,
            momentum=args.momentum,
            learning_rate_decay_factor=args.learning_rate_decay_factor,
            decay_steps=args.decay_steps,
            rmsprop_decay=args.rmsprop_decay,
            adam_beta1=args.adam_beta1,
            adam_beta2=args.adam_beta2,
            epsilon=args.epsilon))
    data = train_loop.DataConfig(
        train_coords=args.train_coords,
        data_volumes=args.data_volumes,
        label_volumes=args.label_volumes,
        image_mean=args.image_mean,
        image_stddev=args.image_stddev,
        permutable_axes=tuple(args.permutable_axes),
        reflectable_axes=tuple(args.reflectable_axes))
    loop = train_loop.LoopConfig(
        train_dir=args.train_dir,
        max_steps=args.max_steps,
        summary_every_steps=args.summary_every_steps,
        checkpoint_every_steps=args.checkpoint_every_steps,
        random_seed=args.random_seed,
        stall_timeout_secs=args.stall_timeout_secs)
    run = (train_loop.run_training_host_loop if args.trainer == "host_loop"
           else train_loop.run_training)
    return run(args.model_name, args.model_args or "", config, data, loop,
               device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
