"""The port's host-loop trainer against the JAX package's, on the CPU, at
the JAX CLI tests' size (9^3 FOV, deltas 2, depth 2, 4 features), the
same numpy inputs and JAX initial parameters (conv_lom raised, as in
test_torch_train.py, so the data-dependent policies move). Tolerances:
K16's plain version against JAX's loss (1e-6 relative) and jax.grad (1e-6
of its largest: JAX adds sigmoid_ce's three derivatives one by one);
make_fov_train_step, 3 steps: parameters, EMA, logits 1e-5, loss 1e-6
relative; the policies, write-back and tracker bit for bit (numpy in
both); run_training_host_loop at batch 1 with synchronous loaders (the
prefetch thread's RNG draw at a save depends on thread timing in both
packages): checkpoints within 1e-5, move counts equal.
"""

import json
import os
import signal
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logit

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import model_info as jax_model_info
from ffn_tpu.training import examples as jax_examples
from ffn_tpu.training import optimizer as jax_optimizer
from ffn_tpu.training import precision as jax_precision
from ffn_tpu.training import tracker as jax_tracker
from ffn_tpu.training import train_lib as jax_train_lib
from ffn_tpu.training import train_loop as jax_train_loop
from ffn_tpu_torch.cli import train as train_cli
from ffn_tpu_torch.models import convstack_3d
from ffn_tpu_torch.models import model_info
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops import train as train_ops
from ffn_tpu_torch.training import examples
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import tracker
from ffn_tpu_torch.training import train_lib
from ffn_tpu_torch.training import train_loop
from test_torch_train_loop import dataset  # noqa: F401 (a fixture)

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

MODEL = dict(fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
ARGS = json.dumps(MODEL)
NAME = "convstack_3d.ConvStack3DFFNModel"
LOM_BIAS, LOM_SCALE = 5.2, 100.0
PARAM_ATOL = 1e-5
STEP_LOSS_RTOL = 1e-6
POLICIES = ("fixed", "fixed_window", "max_pred_moves", "no_step")


@pytest.fixture(scope="module")
def jax_init():
    # The shapes of the JAX init, drawn with numpy (flax's init would cost
    # a compile): kernels of the JAX init's scale, biases of a tenth of it.
    rng = np.random.RandomState(0)
    tree = {}
    for name, p in convstack_3d.ConvStack3DFFNModel(
            **MODEL).module.named_parameters():
        _, layer, leaf = params_io.jax_name(name).split("/")
        tree.setdefault(layer, {})[leaf] = (
            rng.randn(*p.shape) * (0.01 if leaf == "kernel" else 0.001)
        ).astype(np.float32)
    return {"params": tree}


@pytest.fixture(scope="module")
def init_params(jax_init):
    params = jax.tree.map(np.copy, jax_init)
    lom = params["params"]["conv_lom"]
    lom["bias"] = np.full((1,), LOM_BIAS, np.float32)
    lom["kernel"] = lom["kernel"] * np.float32(LOM_SCALE)
    return params


def assert_tree_close(jax_tree, port, atol=PARAM_ATOL):
    flat = params_io._flatten(jax.tree.map(np.asarray, jax_tree))
    for name, t in port.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   flat[params_io.jax_name(name)], atol=atol,
                                   rtol=0, err_msg=name)


# -- K16 ----------------------------------------------------------------------

def test_k16_plain_matches_jax():
    rng = np.random.RandomState(16)
    shape = (2, 9, 9, 9, 1)
    x = (rng.randn(*shape) * 4).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [0.0, 30.0, -30.0, 0.0, 30.0, -30.0]
    flat[10] = np.nan
    y = rng.choice([0.05, 0.95], shape).astype(np.float32)
    w = rng.rand(*shape).astype(np.float32)
    w.reshape(-1)[3:9] = 0.0
    w.reshape(-1)[20:40] = 0.0

    def jax_loss(xx):
        return (jax_train_lib.sigmoid_ce(xx, y) * w).mean()

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(x))
    grad, loss = train_ops.fov_loss(*(torch.from_numpy(a) for a in (x, y, w)),
                                    train_ops.new_ticket("cpu"))
    assert np.isnan(float(loss)) and np.isnan(float(want_loss))
    atol = 1e-6 * float(np.nanmax(np.abs(want_grad)))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=atol, equal_nan=True)
    # Without the NaN, the loss too.
    flat[10] = 1.0
    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(x))
    grad, loss = train_ops.fov_loss_plain(
        *(torch.from_numpy(a) for a in (x, y, w)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=atol)
    # x = 0: -w y / N (max splits its tie 0.5/0.5, abs' derivative at 0
    # is 1, so the log1p term's -0.5 cancels the 0.5).
    np.testing.assert_allclose(grad.numpy().reshape(-1)[0],
                               -w.reshape(-1)[0] * y.reshape(-1)[0] / x.size,
                               rtol=1e-6)


# -- make_fov_train_step ------------------------------------------------------

def fov_batches(steps, b=2, nan_at=None):
    rng = np.random.RandomState(7)
    out = []
    for s in range(steps):
        shape = (b, 9, 9, 9, 1)
        seed = (rng.randn(*shape) * 2).astype(np.float32)
        image = rng.randn(*shape).astype(np.float32)
        labels = rng.choice([0.05, 0.95], shape).astype(np.float32)
        weights = (rng.rand(*shape) > 0.2).astype(np.float32)
        if s == nan_at:
            image[0, 4, 4, 4, 0] = np.nan
        out.append((seed, image, labels, weights))
    return out


def configs(optimizer, ema_decay=0.0):
    kw = dict(fov_size=(9, 9, 9), deltas=(2, 2, 2), depth=2, features=4,
              batch_size=2, ema_decay=ema_decay)
    opt = dict(optimizer=optimizer, learning_rate=0.01)
    return (jax_train_lib.TrainConfig(
                **kw, optimizer=jax_optimizer.OptimizerConfig(**opt)),
            train_lib.TrainConfig(
                **kw, optimizer=optimizer_lib.OptimizerConfig(**opt)))


def both_steps(init_params, optimizer, ema_decay, legacy):
    jcfg, tcfg = configs(optimizer, ema_decay)
    jmodel = jax_convstack.ConvStack3DFFNModel(**MODEL)
    tx = jax_optimizer.optimizer_from_config(jcfg.optimizer)
    jstep = jax_train_lib.make_fov_train_step(
        jmodel, tx, config=None if legacy else jcfg)
    tmodel = convstack_3d.ConvStack3DFFNModel(**MODEL)
    tmodel.load_params(init_params)
    state, opt = train_lib.create_train_state(tmodel, tcfg)
    tstep = train_lib.make_fov_train_step(tmodel, opt,
                                          config=None if legacy else tcfg)
    params = jax.tree.map(jnp.asarray, init_params)
    jstate = [params, tx.init(params),
              jax.tree.map(jnp.array, params) if ema_decay else None,
              jax_precision.NoOpLossScale()]
    return jstep, jstate, tstep, state


@pytest.mark.parametrize("optimizer,ema_decay", [("sgd", 0.0),
                                                 ("adam", 0.9)])
def test_fov_step_matches_jax(jax_init, optimizer, ema_decay):
    jstep, jstate, tstep, state = both_steps(jax_init, optimizer,
                                             ema_decay, legacy=False)
    tstate = [state.params, state.opt_state, state.ema_params,
              state.scale_state]
    for arrays in fov_batches(3):
        *jstate, jlogits, jloss = jstep(*jstate, *map(jnp.asarray, arrays))
        *tstate, tlogits, tloss = tstep(*tstate, *map(torch.from_numpy,
                                                      arrays))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=STEP_LOSS_RTOL)
        assert_tree_close(jstate[0], state.params)
        if ema_decay:
            assert_tree_close(jstate[2], state.ema_params)


def test_legacy_fov_step_matches_jax_and_keeps_nan(jax_init):
    # The legacy step applies the update ungated: a NaN in the image makes
    # NaN gradients, and the parameters take them, as in the JAX step.
    # The config form skips that update and still moves the EMA.
    jstep, jstate, tstep, state = both_steps(jax_init, "sgd", 0.0,
                                             legacy=True)
    params, opt_state = jstate[:2]
    for arrays in fov_batches(2, nan_at=1):
        params, opt_state, jlogits, jloss = jstep(
            params, opt_state, *map(jnp.asarray, arrays))
        _, _, tlogits, tloss = tstep(state.params, state.opt_state,
                                     *map(torch.from_numpy, arrays))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=PARAM_ATOL, rtol=0, equal_nan=True)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=STEP_LOSS_RTOL, equal_nan=True)
    flat = params_io._flatten(jax.tree.map(np.asarray, params))
    assert np.isnan(flat["params/conv0_a/kernel"]).any()
    for name, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   flat[params_io.jax_name(name)],
                                   atol=PARAM_ATOL, rtol=0, equal_nan=True,
                                   err_msg=name)

    jstep, jstate, tstep, state = both_steps(jax_init, "sgd", 0.5,
                                             legacy=False)
    tstate = [state.params, state.opt_state, state.ema_params,
              state.scale_state]
    for arrays in fov_batches(2, nan_at=1):
        *jstate, _, _ = jstep(*jstate, *map(jnp.asarray, arrays))
        *tstate, _, _ = tstep(*tstate, *map(torch.from_numpy, arrays))
    assert all(bool(torch.isfinite(t).all()) for t in state.params.values())
    assert_tree_close(jstate[0], state.params)
    assert_tree_close(jstate[2], state.ema_params)


# -- the policies, BatchExampleIter and the tracker ---------------------------

def _policy(lib, name, threshold, shifts, info):
    if name == "fixed":
        return lambda i, s, lab, t: lib.fixed_offsets(
            i, s, lab, t, threshold=threshold, fov_shifts=shifts)
    if name == "fixed_window":
        return lambda i, s, lab, t: lib.fixed_offsets_window(
            i, s, lab, t, threshold=threshold, fov_shifts=shifts, radius=1)
    if name == "max_pred_moves":
        return lambda i, s, lab, t: lib.max_pred_offsets(
            i, s, lab, t, threshold=threshold,
            max_radius=np.array(info.deltas) * 2)
    return lib.no_offsets


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy):
    rng = np.random.RandomState(3)
    canvas = (1, 21, 21, 21, 1)
    threshold = float(logit(0.9))
    shifts = model_info.shift_collection((2, 2, 2))
    results = []
    for lib, info_lib, tracker_lib in (
            (jax_examples, jax_model_info, jax_tracker),
            (examples, model_info, tracker)):
        rng.seed(3)
        seed = (rng.randn(*canvas) * 3).astype(np.float32)
        labels = rng.choice([0.05, 0.95], canvas).astype(np.float32)
        info = info_lib.ModelInfo(deltas=(2, 2, 2), pred_mask_size=(9,) * 3,
                                  input_seed_size=(9,) * 3,
                                  input_image_size=(9,) * 3)
        t = tracker_lib.EvalTracker((13, 13, 13), shifts_xyz=shifts)
        offsets = []
        for off in _policy(lib, policy, threshold, shifts, info)(
                info, seed, labels, t):
            offsets.append(tuple(int(v) for v in off))
            # The write-back between moves, as the trainer makes it.
            centre = np.array(seed.shape[1:4]) // 2 + np.array(off[::-1])
            seed[0, centre[0], centre[1], centre[2], 0] += 1.0
        results.append((offsets, t.get_summaries()))
    (joff, jsum), (toff, tsum) = results
    assert toff == joff and len(toff) >= (1 if policy == "no_step" else 3)
    assert tsum == jsum


@pytest.mark.parametrize("pred", [9, 5])
def test_batch_example_iter_writes_back_as_jax(pred):
    # Two slots walk the fixed policy's moves over one example each; the
    # logits written back after each step show in the next crops.
    rng = np.random.RandomState(5)
    image = rng.randn(1, 17, 17, 17, 1).astype(np.float32)
    labels = rng.choice([0.05, 0.95], (1, 17, 17, 17, 1)).astype(np.float32)
    weights = np.ones_like(labels)
    logits = [(rng.rand(2, pred, pred, pred, 1) * 8 - 2).astype(np.float32)
              for _ in range(8)]
    threshold = float(logit(0.9))
    shifts = model_info.shift_collection((2, 2, 2))
    batches = []
    for lib, info_lib, tracker_lib in (
            (jax_examples, jax_model_info, jax_tracker),
            (examples, model_info, tracker)):
        info = info_lib.ModelInfo(deltas=(2, 2, 2),
                                  pred_mask_size=(pred,) * 3,
                                  input_seed_size=(9,) * 3,
                                  input_image_size=(9,) * 3)
        t = tracker_lib.EvalTracker((pred + 4,) * 3, shifts_xyz=shifts)
        policy = _policy(lib, "fixed", threshold, shifts, info)

        def make_gen(lib=lib, info=info, t=t, policy=policy):
            return lib.get_example(
                lambda: (image, labels, weights, (8, 8, 8), "v"), t, info,
                policy, seed_pad=0.05, seed_shape=(13, 13, 13))

        it = lib.BatchExampleIter(make_gen, t, 2, info)
        got = []
        for step_logits in logits:
            got.append(next(it))
            it.update_seeds(step_logits)
        batches.append((got, t.get_summaries()))
    (jb, jsum), (tb, tsum) = batches
    for j, t in zip(jb, tb):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
    assert tsum == jsum
    # The written logits reached the seeds the next step reads.
    assert any((b[0] > 0.5).sum() > 2 for b in tb[1:])


# -- run_training_host_loop ---------------------------------------------------

class SyncLoader:
    """A PrefetchingLoader without its thread (module docstring)."""

    def __init__(self, loader, capacity=16):
        del capacity
        self._loader = loader
        self.consumed = 0

    def __call__(self):
        self.consumed += 1
        return self._loader()


def loop_configs(tmp, train_dir, max_steps, port, policy, ema_decay=0.0):
    lib, optim, loop_lib = ((train_lib, optimizer_lib, train_loop) if port
                            else (jax_train_lib, jax_optimizer,
                                  jax_train_loop))
    config = lib.TrainConfig(
        fov_size=(9, 9, 9), deltas=(2, 2, 2), depth=2, features=4,
        batch_size=1, fov_policy=policy, ema_decay=ema_decay,
        optimizer=optim.OptimizerConfig(optimizer="adam",
                                        learning_rate=0.003))
    data = loop_lib.DataConfig(
        train_coords=str(tmp / "coords_fg.npz"),
        data_volumes=(f"v:{tmp}/img.npy" if port
                      else f"v:{tmp}/data.h5:img"),
        label_volumes=f"v:{tmp}/data.h5:seg",
        image_mean=128.0, image_stddev=33.0)
    loop = loop_lib.LoopConfig(
        train_dir=str(train_dir), max_steps=max_steps, summary_every_steps=1,
        checkpoint_every_steps=max_steps, max_to_keep=0)
    return config, data, loop


@pytest.fixture(scope="module")
def fg_dataset(dataset):  # noqa: F811
    """The dataset's volumes with centres deep inside its three objects,
    so that moves of the max_pred_moves BFS are wanted and examples span
    several steps."""
    centers = np.array([(12, 12, 12), (30, 30, 30), (20, 30, 12)] * 20,
                       np.int64)   # xyz
    np.savez_compressed(str(dataset / "coords_fg.npz"), center=centers,
                        label_volume_name=np.array(["v"] * len(centers)))
    return dataset


def run_both(dataset, init_params, root, steps, policy, ema_decay=0.0):
    """Both packages' host loops in root/jax and root/port (resuming what
    those hold)."""
    jparams = jax.tree.map(jnp.asarray, init_params)
    with mock.patch.object(jax_train_loop.inputs_lib, "PrefetchingLoader",
                           SyncLoader), \
            mock.patch.object(jax_convstack.ConvStack3DFFNModel,
                              "init_params", lambda self, rng=None: jparams):
        jax_train_loop.run_training_host_loop(
            NAME, ARGS, *loop_configs(dataset, root / "jax", steps, False,
                                      policy, ema_decay))
    with mock.patch.object(train_loop.inputs_lib, "PrefetchingLoader",
                           SyncLoader):
        train_loop.run_training_host_loop(
            NAME, ARGS, *loop_configs(dataset, root / "port", steps, True,
                                      policy, ema_decay),
            device="cpu", init_params=init_params)


def ckpt(train_dir, prefix, step):
    with np.load(train_dir / "ckpt" / f"{prefix}.ckpt-{step}.npz") as f:
        return {k: f[k] for k in f.files}


def summaries(train_dir):
    with open(train_dir / "summaries.jsonl") as f:
        return [json.loads(line) for line in f]


def assert_runs_match(root, step):
    for prefix in ("model", "opt", "extra"):
        a, b = ckpt(root / "jax", prefix, step), ckpt(root / "port", prefix,
                                                      step)
        assert sorted(a) == sorted(b), prefix
        for k in a:
            if a[k].dtype.kind in "iu":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                np.testing.assert_allclose(b[k], a[k], atol=PARAM_ATOL,
                                           rtol=0, err_msg=f"{prefix} {k}")
    js, ts = summaries(root / "jax"), summaries(root / "port")
    assert [s["step"] for s in ts] == [s["step"] for s in js]
    for j, t in zip(js, ts):
        assert sorted(t) == sorted(j)
        for k in j:
            if k.startswith("moves"):
                assert t[k] == j[k], k


@pytest.mark.parametrize("policy", ["max_pred_moves", "fixed"])
def test_host_loop_matches_jax(fg_dataset, init_params, tmp_path, policy):
    run_both(fg_dataset, init_params, tmp_path, 3, policy)
    assert_runs_match(tmp_path, 3)
    assert summaries(tmp_path / "port")[-1]["moves/total"] >= 3


def test_host_loop_resume_matches_jax(fg_dataset, init_params, tmp_path):
    run_both(fg_dataset, init_params, tmp_path, 2, "max_pred_moves", 0.9)
    run_both(fg_dataset, init_params, tmp_path, 4, "max_pred_moves", 0.9)
    assert_runs_match(tmp_path, 4)
    assert "ema0" in ckpt(tmp_path / "port", "extra", 4)


@pytest.mark.parametrize("policy", POLICIES)
def test_cli_host_loop_trains_with_each_policy(dataset, tmp_path,  # noqa: F811
                                               policy):
    signals = (signal.SIGTERM, signal.SIGINT)
    before = [signal.getsignal(s) for s in signals]
    train_cli.main([
        "--train_coords", str(dataset / "coords.npz"),
        "--data_volumes", f"v:{dataset}/img.npy",
        "--label_volumes", f"v:{dataset}/data.h5:seg",
        "--model_args", ARGS, "--batch_size", "2", "--image_mean", "128",
        "--image_stddev", "33", "--train_dir", str(tmp_path),
        "--max_steps", "2", "--summary_every_steps", "2",
        "--trainer", "host_loop", "--fov_policy", policy, "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "extra.ckpt-2.npz", "model.ckpt-2.npz", "opt.ckpt-2.npz"]
    (line,) = summaries(tmp_path)
    assert line["step"] == 2 and line["moves/total"] >= 1
    assert all(np.isfinite(v).all()
               for v in ckpt(tmp_path, "model", 2).values())
    # The run leaves SIGTERM/SIGINT as it found them.
    assert [signal.getsignal(s) for s in signals] == before
