"""The training loops: data pipeline + train step + checkpoints, one card.

Counterpart of ffn_tpu/training/train_loop.py. `run_training`: an
ExampleBatcher (uint8 patches, augmentation, a prefetch thread with a
resumable cursor) feeds the packed scan step, whose metrics reach the host
one step behind (a pinned copy and an event); checkpoints use the JAX
package's `<train_dir>/ckpt/` layout, so either package resumes the
other's: model.ckpt-N.npz (flat `params/<layer>/kernel|bias`),
opt.ckpt-N.npz (step, leaf0..: optimizer state in JAX leaf order),
extra.ckpt-N.npz (consumed, the offset-shuffle RNG, ema0.., and
scale0/scale1: the f16 policy's loss scale and counter).
`run_training_host_loop`: the reference FFN's stepping for the four FOV
policies (examples.BatchExampleIter; a batch up, make_fov_train_step, the
logits back into the slots' seed canvases); its checkpoints carry a data
cursor of 0 and the augmentation RNG. Weights start from torch's
generator seeded with `random_seed`, or `init_params`. Multi-process
training and meshes raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from scipy.special import logit as np_logit

from ffn_tpu_torch.inference import storage
from ffn_tpu_torch.inference.engine import resolve_device
from ffn_tpu_torch.models import model_info as mi
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.models import registry
from ffn_tpu_torch.training import augmentation
from ffn_tpu_torch.training import examples as examples_lib
from ffn_tpu_torch.training import inputs as inputs_lib
from ffn_tpu_torch.training import precision as precision_lib
from ffn_tpu_torch.training import tracker as tracker_lib
from ffn_tpu_torch.training import train_lib


@dataclasses.dataclass
class DataConfig:
    train_coords: str = ""
    data_volumes: str = ""    # name:path:dataset[,...]; .npy paths too
    label_volumes: str = ""
    image_mean: float = 128.0
    image_stddev: float = 33.0
    permutable_axes: tuple = (1, 2)   # of the 3 spatial axes (z=0, y=1, x=2)
    reflectable_axes: tuple = (0, 1, 2)


@dataclasses.dataclass
class LoopConfig:
    train_dir: str = "/tmp/ffn_tpu_train"
    max_steps: int = 10000
    summary_every_steps: int = 100
    checkpoint_every_steps: int = 1000
    random_seed: int = 0
    max_to_keep: int = 5
    keep_every_n_steps: int = 0
    stall_timeout_secs: float = 0.0


class _StallWatchdog:
    """Hard-exits a wedged training process so a supervisor can restart:
    a daemon thread needs a `beat()` at least every `timeout` seconds, and
    otherwise dumps all stacks (faulthandler) and calls os._exit(42)."""

    EXIT_CODE = 42

    def __init__(self, timeout_secs: float):
        import threading
        self._timeout = timeout_secs
        self._last = time.time()
        self._stopped = False
        if timeout_secs > 0:
            t = threading.Thread(target=self._watch, daemon=True)
            t.start()

    def beat(self):
        self._last = time.time()

    def stop(self):
        self._stopped = True

    def _watch(self):
        import faulthandler
        import sys
        while not self._stopped:
            time.sleep(min(self._timeout / 4, 30.0))
            if self._stopped:
                return
            if time.time() - self._last > self._timeout:
                logging.error(
                    "No training progress for %.0f s — assuming a wedged "
                    "device/data pipeline; dumping stacks and exiting %d "
                    "for supervised restart.", self._timeout,
                    self.EXIT_CODE)
                faulthandler.dump_traceback(file=sys.stderr,
                                            all_threads=True)
                sys.stderr.flush()
                os._exit(self.EXIT_CODE)


class ExampleBatcher:
    """Yields full-canvas training batches for the scan trainer, with a
    resumable data-iterator cursor: the coordinate stream, bounds filter
    and augmentation draws are deterministic functions of (seed, examples
    consumed), so `fast_forward(n)` reproduces the position of a run that
    consumed n examples. The same draws as the JAX package's
    ExampleBatcher (random.Random and np.random.RandomState, unchanged)."""

    def __init__(self, data: DataConfig, config: train_lib.TrainConfig,
                 info, rng_seed: int = 0, packed: bool = False,
                 shard_index: int = 0, shard_count: int = 1,
                 aug_seed: Optional[int] = None):
        self._batch_size = config.batch_size
        self._packed = packed
        self._canvas_zyx = tuple(
            int(v) for v in train_lib.train_canvas_size(info, config)[::-1])
        image_zyx = tuple(
            int(v) for v in train_lib.train_image_size(info, config)[::-1])
        label_zyx = tuple(
            int(v) for v in train_lib.train_labels_size(info, config)[::-1])
        self._seed_pad = config.seed_pad
        self._seed_init = config.seed_init
        self._transform = augmentation.PermuteAndReflect(
            rank=5,
            permutable_axes=[a + 1 for a in data.permutable_axes],
            reflectable_axes=[a + 1 for a in data.reflectable_axes],
            rng=np.random.RandomState(
                rng_seed if aug_seed is None else aug_seed))

        def augment(*arrays):
            perm, flips = self._transform.sample()
            return tuple(self._transform.apply(a, perm, flips)
                         for a in arrays)

        self._raw_loader = inputs_lib.ExampleLoader(
            data.train_coords,
            image_volume_map=inputs_lib.parse_volume_map(data.data_volumes),
            label_volume_map=inputs_lib.parse_volume_map(data.label_volumes),
            image_size_xyz=image_zyx[::-1], label_size_xyz=label_zyx[::-1],
            image_mean=data.image_mean, image_stddev=data.image_stddev,
            augment=augment, seed=rng_seed, raw=packed,
            shard_index=shard_index, shard_count=shard_count)
        self._loader = None  # prefetch started lazily / after fast_forward

    def fast_forward(self, n_examples: int) -> None:
        """Positions the pipeline as if n_examples were already consumed.
        Must be called before the first batch."""
        if self._loader is not None:
            raise RuntimeError("fast_forward before the first batch")
        if n_examples <= 0:
            return
        self._raw_loader.fast_forward(n_examples)
        for _ in range(n_examples):
            self._transform.sample()

    @property
    def consumed(self) -> int:
        """Examples handed to the trainer so far (the checkpoint cursor)."""
        return self._loader.consumed if self._loader is not None else 0

    def __call__(self):
        if self._loader is None:
            self._loader = inputs_lib.PrefetchingLoader(
                self._raw_loader, capacity=4 * self._batch_size)
        if self._packed:
            images, masks = [], []
            while len(images) < self._batch_size:
                img, mask, _, _, _ = self._loader()
                images.append(img)
                masks.append(mask)
            return np.concatenate(images), np.concatenate(masks)
        images, labels, weights = [], [], []
        while len(images) < self._batch_size:
            img, lab, w, _, _ = self._loader()
            images.append(img)
            labels.append(lab)
            weights.append(w)
        seeds = train_lib.make_seed_canvas(
            self._batch_size, self._canvas_zyx, self._seed_pad,
            self._seed_init)
        return (seeds, np.concatenate(images), np.concatenate(labels),
                np.concatenate(weights))


def build_model(model_name: str, model_args: str,
                config: train_lib.TrainConfig):
    """The model of `run_training` (weights as the constructor draws them);
    the precision policy's compute dtype unless `model_args` names one, as
    ffn_tpu/training/train_loop.py:238-244."""
    model_cls = registry.import_symbol(model_name)
    kwargs = json.loads(model_args) if model_args else {}
    kwargs.setdefault("fov_size", list(config.fov_size))
    kwargs.setdefault("deltas", list(config.deltas))
    kwargs.setdefault("depth", config.depth)
    kwargs.setdefault("features", config.features)
    if config.precision != "f32":
        policy = precision_lib.get_policy(config.precision)
        kwargs.setdefault("dtype", policy.compute_dtype)
        kwargs.setdefault("precision", None)
    return model_cls(**kwargs)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        # Pinned, so the copy queues behind the running step.
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _to_host(metrics: dict, device: torch.device):
    """(host copies of the metrics, an event that marks them ready)."""
    if device.type != "cuda":
        return {k: v.detach().clone() for k, v in metrics.items()}, None
    host = {k: v.to("cpu", non_blocking=True) for k, v in metrics.items()}
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_training(model_name: str, model_args: str,
                 config: train_lib.TrainConfig, data: DataConfig,
                 loop: LoopConfig, mesh=None, device="cuda",
                 init_params=None) -> dict:
    """Runs FFN training on one device; returns the final summaries.

    `init_params`: JAX-layout parameters (a flat npz dict or a flax tree)
    to start from instead of the model's seeded draw.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported to ffn_tpu_torch yet (ROADMAP.md): the port "
            "trains on one card")
    device = resolve_device(device)
    train_lib.check_scan_config(config)
    model = _initial_model(model_name, model_args, config, loop, device,
                           init_params)
    info = model.info

    state, opt = train_lib.create_train_state(model, config)
    packed = config.packed_transfers
    step_fn = (train_lib.make_scan_train_step_packed if packed
               else train_lib.make_scan_train_step)(model, opt, config)

    next_batch = ExampleBatcher(data, config, info,
                                rng_seed=loop.random_seed, packed=packed,
                                aug_seed=loop.random_seed)
    eval_shape = tuple(int(v)
                       for v in train_lib.train_eval_size(info, config)[::-1])
    tracker = tracker_lib.EvalTracker(
        eval_shape, shifts_xyz=mi.shift_collection(info.deltas))

    os.makedirs(loop.train_dir, exist_ok=True)
    shuffle_rng = np.random.RandomState(loop.random_seed)

    # Resume from the latest checkpoint if present: params, optimizer,
    # EMA, offset-shuffle RNG, and the data-iterator cursor.
    start_step = 0
    consumed_base = 0
    ckpt_dir = os.path.join(loop.train_dir, "ckpt")
    latest = _latest_checkpoint(ckpt_dir)
    if latest is not None:
        start_step = latest
        _restore(ckpt_dir, latest, model, opt, state.opt_state)
        consumed_base = _restore_extra(ckpt_dir, latest, state.ema_params,
                                       shuffle_rng, state.scale_state)
        if consumed_base is None:
            # Old-format checkpoint without a data cursor: assume the
            # scan trainer's fixed consumption rate.
            consumed_base = start_step * config.batch_size
        next_batch.fast_forward(consumed_base)
        logging.info("Resumed from step %d (data cursor %d)", start_step,
                     consumed_base)
    state.step = start_step

    stop = _PreemptionWatcher()
    watchdog = _StallWatchdog(loop.stall_timeout_secs)

    def save(step):
        _save(ckpt_dir, step, model, opt, state.opt_state)
        _save_extra(ckpt_dir, step, state.ema_params, shuffle_rng,
                    consumed_base + next_batch.consumed, state.scale_state)
        _apply_keep_policy(ckpt_dir, loop)

    t_last = time.time()
    summaries = {}
    # Metrics of step N are read on the host while step N+1 runs on the
    # device: (host metrics, their ready event, offsets) awaiting ingest.
    pending = None

    def ingest(entry):
        if entry is None:
            return
        host, event, offs = entry
        if event is not None:
            event.synchronize()
        _update_tracker_packed(tracker, host, offs)

    def emit_summary(step, host):
        nonlocal summaries, t_last
        summaries = tracker.get_summaries()
        losses = np.asarray(host["loss"])
        act = np.asarray(host["active"]) > 0
        dt = time.time() - t_last
        t_last = time.time()
        logging.info(
            "step %d loss %.4f moves/correct %.3f (%.2f steps/s)",
            step, float(losses[act].mean()), summaries["moves/correct"],
            loop.summary_every_steps / dt)
        _write_summaries(loop.train_dir, step, summaries)

    try:
        for step in range(start_step, loop.max_steps):
            offsets_np = train_lib.fixed_offsets_zyx(
                info, shuffle=config.shuffle_fov_moves, rng=shuffle_rng)
            if packed:
                image_u8, lom_u8 = next_batch()
                state, metrics = step_fn(
                    state, _to_device(image_u8, device),
                    _to_device(lom_u8, device), offsets_np)
                host, event = _to_host(metrics, device)
                # The device is busy with THIS step; ingest the previous one.
                ingest(pending)
                pending = (host, event, offsets_np)
            else:
                seeds, images, labels, weights = next_batch()
                state, out_seeds, metrics = step_fn(
                    state, _to_device(seeds, device),
                    _to_device(images, device), _to_device(labels, device),
                    _to_device(weights, device), offsets_np)
                host = {k: v.cpu() for k, v in metrics.items()}
                _update_tracker(tracker, host, offsets_np, labels,
                                out_seeds.cpu().numpy(), weights)

            watchdog.beat()
            preempted = stop.requested
            boundary = ((step + 1) % loop.summary_every_steps == 0
                        or (step + 1) % loop.checkpoint_every_steps == 0
                        or step + 1 == loop.max_steps or preempted)
            if boundary and pending is not None:
                ingest(pending)   # flush so summaries/ckpts see this step
                pending = None

            if (step + 1) % loop.summary_every_steps == 0:
                emit_summary(step + 1, host)

            if (step + 1) % loop.checkpoint_every_steps == 0 or \
                    step + 1 == loop.max_steps or preempted:
                save(step + 1)
            if preempted:
                logging.info("Preemption requested; checkpointed at step %d "
                             "and exiting.", step + 1)
                break
    finally:
        watchdog.stop()
        stop.restore()
    return summaries


def _initial_model(model_name, model_args, config, loop, device,
                   init_params):
    """build_model with torch's generator seeded with loop.random_seed (or
    `init_params` loaded), on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(loop.random_seed)
        model = build_model(model_name, model_args, config)
    if init_params is not None:
        model.load_params(init_params)
    model.module.to(device)
    return model


def _policy_fn(config: train_lib.TrainConfig, info):
    """The FOV-movement policy (ffn_tpu/training/train_loop.py:524-544,
    the reference's map plus the JAX trainer's fixed_window)."""
    threshold = float(np_logit(config.threshold))
    shifts = mi.shift_collection(info.deltas)
    if config.fov_policy == "fixed":
        def policy_fn(i, s, l, t):
            return examples_lib.fixed_offsets(
                i, s, l, t, threshold=threshold, fov_shifts=shifts)
    elif config.fov_policy == "fixed_window":
        def policy_fn(i, s, l, t):
            return examples_lib.fixed_offsets_window(
                i, s, l, t, threshold=threshold, fov_shifts=shifts,
                radius=int(config.fixed_window_radius))
    elif config.fov_policy == "max_pred_moves":
        max_radius = np.array(info.deltas) * config.fov_moves

        def policy_fn(i, s, l, t):
            return examples_lib.max_pred_offsets(
                i, s, l, t, threshold=threshold, max_radius=max_radius)
    elif config.fov_policy == "no_step":
        policy_fn = examples_lib.no_offsets
    else:
        raise ValueError(f"unknown fov_policy {config.fov_policy!r}")
    return policy_fn


def run_training_host_loop(model_name: str, model_args: str,
                           config: train_lib.TrainConfig, data: DataConfig,
                           loop: LoopConfig, device="cuda",
                           init_params=None) -> dict:
    """Host-loop trainer on one device; returns the final summaries.

    The JAX package's stepping (ffn_tpu/training/train_loop.py:452-607):
    one make_fov_train_step per FOV batch, the logits written back into
    the examples' seed canvases on the host between moves. `init_params`
    as in run_training.
    """
    device = resolve_device(device)
    train_lib.check_config(config)
    model = _initial_model(model_name, model_args, config, loop, device,
                           init_params)
    info = model.info

    state, opt = train_lib.create_train_state(model, config)
    params, opt_state = state.params, state.opt_state
    ema_params, scale_state = state.ema_params, state.scale_state
    step_fn = train_lib.make_fov_train_step(model, opt, config=config)

    canvas_zyx = tuple(int(v) for v in
                       train_lib.train_canvas_size(info, config)[::-1])
    image_zyx = tuple(int(v) for v in
                      train_lib.train_image_size(info, config)[::-1])
    label_zyx = tuple(int(v) for v in
                      train_lib.train_labels_size(info, config)[::-1])
    eval_shape = tuple(int(v) for v in
                       train_lib.train_eval_size(info, config)[::-1])
    tracker = tracker_lib.EvalTracker(
        eval_shape, shifts_xyz=mi.shift_collection(info.deltas))

    rng = np.random.RandomState(loop.random_seed)
    transform = augmentation.PermuteAndReflect(
        rank=5, permutable_axes=[a + 1 for a in data.permutable_axes],
        reflectable_axes=[a + 1 for a in data.reflectable_axes], rng=rng)

    def augment(*arrays):
        perm, flips = transform.sample()
        return tuple(transform.apply(a, perm, flips) for a in arrays)

    raw_loader = inputs_lib.ExampleLoader(
        data.train_coords,
        image_volume_map=inputs_lib.parse_volume_map(data.data_volumes),
        label_volume_map=inputs_lib.parse_volume_map(data.label_volumes),
        image_size_xyz=image_zyx[::-1], label_size_xyz=label_zyx[::-1],
        image_mean=data.image_mean, image_stddev=data.image_stddev,
        augment=augment, seed=loop.random_seed)
    policy_fn = _policy_fn(config, info)

    os.makedirs(loop.train_dir, exist_ok=True)
    ckpt_dir = os.path.join(loop.train_dir, "ckpt")
    start_step = 0
    latest = _latest_checkpoint(ckpt_dir)
    if latest is not None:
        start_step = latest
        _restore(ckpt_dir, latest, model, opt, opt_state)
        _restore_extra(ckpt_dir, latest, ema_params, rng, scale_state)
        logging.info("Resumed from step %d", start_step)

    # The prefetch thread starts after the restore, so that every
    # augmentation draw comes from the restored RNG.
    loader = inputs_lib.PrefetchingLoader(raw_loader,
                                          capacity=4 * config.batch_size)

    def make_gen():
        return examples_lib.get_example(
            loader, tracker, info, policy_fn, seed_pad=config.seed_pad,
            seed_shape=canvas_zyx)

    batch_it = examples_lib.BatchExampleIter(make_gen, tracker,
                                             config.batch_size, info)

    stop = _PreemptionWatcher()
    t_last = time.time()
    summaries = {}
    try:
        for step in range(start_step, loop.max_steps):
            seeds, images, labels, weights = next(batch_it)
            batch = _to_device(np.stack([seeds, images, labels, weights]),
                               device)
            (params, opt_state, ema_params, scale_state, logits,
             loss) = step_fn(params, opt_state, ema_params, scale_state,
                             *batch.unbind(0))
            # A synchronous copy: update_seeds writes through the examples'
            # seed views, so the logits must have arrived.
            batch_it.update_seeds(logits.cpu().numpy())

            if (step + 1) % loop.summary_every_steps == 0:
                summaries = tracker.get_summaries()
                dt = time.time() - t_last
                t_last = time.time()
                logging.info("step %d loss %.4f moves/correct %.3f "
                             "(%.2f steps/s)", step + 1, float(loss),
                             summaries["moves/correct"],
                             loop.summary_every_steps / dt)
                _write_summaries(loop.train_dir, step + 1, summaries)
            if (step + 1) % loop.checkpoint_every_steps == 0 or \
                    step + 1 == loop.max_steps or stop.requested:
                _save(ckpt_dir, step + 1, model, opt, opt_state)
                _save_extra(ckpt_dir, step + 1, ema_params, rng, 0,
                            scale_state)
                _apply_keep_policy(ckpt_dir, loop)
            if stop.requested:
                logging.info("Preemption requested; checkpointed at step %d "
                             "and exiting.", step + 1)
                break
    finally:
        stop.restore()
    return summaries


def _update_tracker_packed(tracker, metrics, offsets):
    """Feeds the per-offset move stats and the eval-patch loss and
    confusion counts of one packed step (host copies) into the tracker."""
    host = {k: np.asarray(metrics[k]) for k in (
        "correct", "missed", "spurious", "patch_loss", "tp", "fp", "fn",
        "tn")}
    correct, missed, spurious = (host["correct"], host["missed"],
                                 host["spurious"])
    for i, off in enumerate(np.asarray(offsets)):
        off_xyz = tuple(int(v) for v in off[::-1])
        radius = int(np.linalg.norm(off_xyz))
        for stats in (tracker.moves, tracker.moves_by_radius[radius]):
            stats.total += int(correct[i] + missed[i] + spurious[i])
            stats.correct += int(correct[i])
            stats.missed += int(missed[i])
            stats.spurious += int(spurious[i])
    tracker.loss_sum += float(host["patch_loss"])
    tracker.loss_count += 1
    tracker.tp += int(host["tp"])
    tracker.fp += int(host["fp"])
    tracker.fn += int(host["fn"])
    tracker.tn += int(host["tn"])
    tracker.num_patches += 1


def _update_tracker(tracker, metrics, offsets, labels, out_seeds, weights):
    """Feeds the per-offset stats and the finished canvases of one
    explicit-canvas step into the tracker."""
    correct = np.asarray(metrics["correct"])
    missed = np.asarray(metrics["missed"])
    spurious = np.asarray(metrics["spurious"])
    for i, off in enumerate(np.asarray(offsets)):
        off_xyz = tuple(int(v) for v in off[::-1])
        radius = int(np.linalg.norm(off_xyz))
        for stats in (tracker.moves, tracker.moves_by_radius[radius]):
            stats.total += int(correct[i] + missed[i] + spurious[i])
            stats.correct += int(correct[i])
            stats.missed += int(missed[i])
            stats.spurious += int(spurious[i])
    tracker.add_patch(labels, np.asarray(out_seeds)[
        :, :labels.shape[1], :labels.shape[2], :labels.shape[3], :],
        weights)


def _write_summaries(train_dir, step, summaries):
    path = os.path.join(train_dir, "summaries.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps({"step": step, **{
            k: float(v) for k, v in summaries.items()}}) + "\n")


class _PreemptionWatcher:
    """Converts SIGTERM/SIGINT into a 'save and exit after this step'
    request (preemption-aware training)."""

    def __init__(self):
        import signal
        self.requested = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread (e.g. under a test runner)

    def restore(self):
        """Puts back the handlers that were there before training."""
        import signal
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)

    def _handler(self, signum, frame):
        del frame
        logging.warning("Signal %s received: checkpointing after the "
                        "current step.", signum)
        self.requested = True


def _ckpt_steps(ckpt_dir) -> list:
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("model.ckpt-") and name.endswith(".npz"):
            steps.append(int(name[len("model.ckpt-"):-len(".npz")]))
    return sorted(steps)


def _apply_keep_policy(ckpt_dir, loop: LoopConfig):
    """Deletes old checkpoints: keep the newest `max_to_keep`, plus every
    step multiple of `keep_every_n_steps`."""
    if loop.max_to_keep <= 0:
        return
    steps = _ckpt_steps(ckpt_dir)
    doomed = steps[:-loop.max_to_keep]
    for step in doomed:
        if loop.keep_every_n_steps and step % loop.keep_every_n_steps == 0:
            continue
        for prefix in ("model.ckpt-", "opt.ckpt-", "extra.ckpt-"):
            path = os.path.join(ckpt_dir, f"{prefix}{step}.npz")
            if os.path.exists(path):
                os.remove(path)
        for path in glob.glob(
                os.path.join(ckpt_dir, f"cursor.ckpt-{step}.p*.npz")):
            os.remove(path)


def _savez(path, **arrays):
    with storage.atomic_file(path) as fd:
        np.savez_compressed(fd, **arrays)


def _save_extra(ckpt_dir, step, ema, shuffle_rng, consumed,
                scale_state=None):
    """Persists the EMA params (JAX leaf order), the offset-shuffle RNG
    state, the data-iterator cursor and the loss scale's leaves (none for
    the f32 and bf16 policies)."""
    arrays = {"consumed": np.int64(consumed)}
    _, s1, s2, s3, s4 = shuffle_rng.get_state()
    arrays["rng_keys"] = np.asarray(s1)
    arrays["rng_meta"] = np.array([s2, s3, s4], np.float64)
    if ema is not None:
        for i, name in enumerate(params_io.jax_leaf_order(ema)):
            arrays[f"ema{i}"] = ema[name].detach().cpu().numpy()
    for i, leaf in enumerate(scale_state.leaves() if scale_state else []):
        arrays[f"scale{i}"] = leaf.cpu().numpy()
    _savez(os.path.join(ckpt_dir, f"extra.ckpt-{step}.npz"), **arrays)


def _restore_extra(ckpt_dir, step, ema, shuffle_rng,
                   scale_state=None) -> Optional[int]:
    """Restores what _save_extra wrote (the EMA and the loss scale in
    place); returns the data cursor, None for old-format checkpoints."""
    path = os.path.join(ckpt_dir, f"extra.ckpt-{step}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        consumed = int(data["consumed"])
        meta = data["rng_meta"]
        shuffle_rng.set_state(("MT19937", data["rng_keys"], int(meta[0]),
                               int(meta[1]), float(meta[2])))
        if ema is not None and "ema0" in data:
            for i, name in enumerate(params_io.jax_leaf_order(ema)):
                t = ema[name]
                t.copy_(torch.as_tensor(np.asarray(
                    data[f"ema{i}"], np.float32).reshape(tuple(t.shape))))
        leaves = scale_state.leaves() if scale_state else []
        if leaves and "scale0" in data:
            for i, t in enumerate(leaves):
                t.copy_(torch.as_tensor(np.asarray(
                    data[f"scale{i}"], _NP[t.dtype]).reshape(())))
    return consumed


_NP = {torch.float32: np.float32, torch.int32: np.int32}


def _save(ckpt_dir, step, model, opt, opt_state):
    os.makedirs(ckpt_dir, exist_ok=True)
    params_io.save_params_npz(
        model.module, os.path.join(ckpt_dir, f"model.ckpt-{step}.npz"))
    leaves = opt.leaves(opt_state)
    _savez(os.path.join(ckpt_dir, f"opt.ckpt-{step}.npz"), step=step,
           **{f"leaf{i}": leaf for i, leaf in enumerate(leaves)})


def _latest_checkpoint(ckpt_dir) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _ckpt_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore(ckpt_dir, step, model, opt, opt_state):
    """Restores the weights into `model` and the optimizer state into
    `opt_state`, in place, from what _save (of either package) wrote."""
    with torch.no_grad():
        model.load_params(params_io.load_params_npz(
            os.path.join(ckpt_dir, f"model.ckpt-{step}.npz")))
        opt_path = os.path.join(ckpt_dir, f"opt.ckpt-{step}.npz")
        if os.path.exists(opt_path):
            with np.load(opt_path) as data:
                n = len([k for k in data.files if k.startswith("leaf")])
                opt.load_leaves(opt_state,
                                [data[f"leaf{i}"] for i in range(n)])
