"""The port's training loop against the JAX package's, on the CPU: both
`run_training`s train the same model (9^3 FOV, deltas 2, depth 2, 4
features, batch 2, adam with EMA) from the same parameters on the same
data (JAX h5, the port `.npy` images). Checkpoints after 3 and 4 steps
within 1e-5 (measured below 1e-6), cursors and summary keys equal; a
killed-and-resumed run equals the uninterrupted one exactly; either
package resumes the other's checkpoints. Also the keep policy, signal
handlers, the CLI (with --precision bf16/f16 against the JAX CLI), and the
options it refuses.
"""

import json
import os
import shutil
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import params_io as jax_params_io
from ffn_tpu.training import optimizer as jax_optimizer
from ffn_tpu.training import precision as jax_precision
from ffn_tpu.training import train_lib as jax_train_lib
from ffn_tpu.training import train_loop as jax_train_loop
from ffn_tpu_torch.cli import train as train_cli
from ffn_tpu_torch.inference import runner as runner_lib
from ffn_tpu_torch.models import convstack_3d
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import train_lib
from ffn_tpu_torch.training import train_loop

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "convstack_3d.ConvStack3DFFNModel"
ARGS = json.dumps({"depth": 2, "features": 4, "fov_size": [9, 9, 9],
                   "deltas": [2, 2, 2]})
ATOL = 1e-5
STEPS = 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traindata")
    rng = np.random.RandomState(0)
    shape = (40, 40, 40)
    seg = np.zeros(shape, np.uint64)
    seg[4:20, 4:20, 4:20] = 1
    seg[22:38, 22:38, 22:38] = 2
    seg[4:20, 22:38, 10:30] = 3
    img = rng.randint(0, 255, shape).astype(np.uint8)
    with h5py.File(str(tmp / "data.h5"), "w") as f:
        f.create_dataset("seg", data=seg)
        f.create_dataset("img", data=img)
    np.save(str(tmp / "img.npy"), img)
    centers = [(x, y, z) for z in (12, 20, 28) for y in (12, 20, 28)
               for x in (12, 20, 28)]
    centers += [(2, 2, 2), (39, 39, 39)]   # out of bounds: filtered
    centers = np.array(centers * 20, np.int64)
    np.savez_compressed(str(tmp / "coords.npz"), center=centers,
                        label_volume_name=np.array(["v"] * len(centers)))
    return tmp


def configs(tmp, train_dir, max_steps, port, **loop_kw):
    kw = dict(fov_size=(9, 9, 9), deltas=(2, 2, 2), depth=2, features=4,
              batch_size=2, ema_decay=0.9)
    opt = dict(optimizer="adam", learning_rate=0.003)
    lib, optim, loop_lib = ((train_lib, optimizer_lib, train_loop) if port
                            else (jax_train_lib, jax_optimizer,
                                  jax_train_loop))
    config = lib.TrainConfig(**kw, optimizer=optim.OptimizerConfig(**opt))
    data = loop_lib.DataConfig(
        train_coords=str(tmp / "coords.npz"),
        data_volumes=(f"v:{tmp}/img.npy" if port
                      else f"v:{tmp}/data.h5:img"),
        label_volumes=f"v:{tmp}/data.h5:seg",
        image_mean=128.0, image_stddev=33.0)
    loop = loop_lib.LoopConfig(
        train_dir=str(train_dir), max_steps=max_steps, summary_every_steps=2,
        checkpoint_every_steps=1, max_to_keep=0, **loop_kw)
    return config, data, loop


@pytest.fixture(scope="module")
def init_params():
    model = jax_convstack.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
    return jax.tree.map(np.asarray, model.init_params(None))


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    train_dir = tmp_path_factory.mktemp("jax_train")
    jax_train_loop.run_training(MODEL, ARGS,
                                *configs(dataset, train_dir, STEPS, False))
    return train_dir


def port_run(dataset, train_dir, max_steps, init_params, **kw):
    return train_loop.run_training(
        MODEL, ARGS, *configs(dataset, train_dir, max_steps, True, **kw),
        device="cpu", init_params=init_params)


@pytest.fixture(scope="module")
def port_dir(dataset, init_params, tmp_path_factory):
    train_dir = tmp_path_factory.mktemp("port_train")
    port_run(dataset, train_dir, STEPS, init_params)
    return train_dir


def load(train_dir, prefix, step):
    with np.load(os.path.join(train_dir, "ckpt",
                              f"{prefix}.ckpt-{step}.npz")) as f:
        return {k: f[k] for k in f.files}


def assert_ckpt_close(a, b, step, atol=ATOL):
    for prefix in ("model", "opt", "extra"):
        x, y = load(a, prefix, step), load(b, prefix, step)
        assert sorted(x) == sorted(y), prefix
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            if atol == 0 or x[k].dtype.kind in "iu":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                np.testing.assert_allclose(x[k], y[k], atol=atol, rtol=0,
                                           err_msg=f"{prefix} {k}")


@pytest.mark.parametrize("step", [3, STEPS])
def test_port_loop_matches_jax_loop(jax_run, port_dir, step):
    assert_ckpt_close(jax_run, port_dir, step)
    assert int(load(port_dir, "extra", step)["consumed"]) == 2 * step


def test_summaries_have_the_jax_keys(jax_run, port_dir):
    def lines(d):
        with open(os.path.join(d, "summaries.jsonl")) as f:
            return [json.loads(line) for line in f]
    a, b = lines(jax_run), lines(port_dir)
    assert [x["step"] for x in a] == [x["step"] for x in b] == [2, 4]
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in ("moves/total", "eval/patches"):
            assert x[k] == y[k], k


def test_kill_and_resume_is_exact(dataset, init_params, port_dir, tmp_path):
    train_dir = tmp_path / "resumed"
    port_run(dataset, train_dir, 2, init_params)
    port_run(dataset, train_dir, STEPS, init_params=None)
    assert_ckpt_close(port_dir, train_dir, STEPS, atol=0)


def test_port_resumes_a_jax_train_dir(dataset, jax_run, tmp_path):
    train_dir = tmp_path / "from_jax"
    os.makedirs(train_dir / "ckpt")
    for prefix in ("model", "opt", "extra"):
        shutil.copy(jax_run / "ckpt" / f"{prefix}.ckpt-2.npz",
                    train_dir / "ckpt")
    port_run(dataset, train_dir, STEPS, init_params=None)
    assert_ckpt_close(jax_run, train_dir, STEPS)


def test_jax_package_restores_the_port_checkpoint(port_dir):
    jcfg = jax_optimizer.OptimizerConfig(optimizer="adam",
                                         learning_rate=0.003)
    model = jax_convstack.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
    template = jax_optimizer.optimizer_from_config(jcfg).init(
        model.init_params(None))
    ckpt = str(port_dir / "ckpt")
    params, opt_state = jax_train_loop._restore(ckpt, STEPS, template)
    ema, _, consumed = jax_train_loop._restore_extra(
        ckpt, STEPS, params, None, np.random.RandomState(0))
    assert consumed == 2 * STEPS
    leaves = [np.asarray(x) for x in jax.tree.leaves(opt_state)]
    want = load(port_dir, "opt", STEPS)
    assert len(leaves) == len(want) - 1   # leaf0.. and the step
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf, want[f"leaf{i}"])
    flat = jax_params_io._flatten(params)
    assert len(flat) == 10
    # The JAX model runs the port's weights.
    out = model.apply(params, np.zeros((1, 9, 9, 9, 1), np.float32),
                      np.zeros((1, 9, 9, 9, 1), np.float32))
    assert np.isfinite(np.asarray(out)).all()
    extra = load(port_dir, "extra", STEPS)
    for i, leaf in enumerate(jax.tree.leaves(ema)):
        np.testing.assert_array_equal(np.asarray(leaf), extra[f"ema{i}"])
    # And the port's inference runner loads them.
    tmodel = convstack_3d.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
    tmodel.load_params(runner_lib.load_model_params(
        os.path.join(ckpt, f"model.ckpt-{STEPS}.npz")))
    for name, p in tmodel.module.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(
            p.detach().numpy(),
            flat[f"params/{layer}/{'kernel' if leaf == 'weight' else leaf}"])


def test_keep_policy(tmp_path):
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    for step in range(1, 8):
        for prefix in ("model", "opt", "extra"):
            np.savez(ckpt / f"{prefix}.ckpt-{step}.npz", x=np.zeros(1))
    train_loop._apply_keep_policy(str(ckpt), train_loop.LoopConfig(
        max_to_keep=2, keep_every_n_steps=3))
    assert train_loop._ckpt_steps(str(ckpt)) == [3, 6, 7]
    assert sorted(os.listdir(ckpt)) == sorted(
        f"{p}.ckpt-{s}.npz" for p in ("model", "opt", "extra")
        for s in (3, 6, 7))


def cli_args(dataset, train_dir, *extra):
    return ["--train_coords", str(dataset / "coords.npz"),
            "--data_volumes", f"v:{dataset}/img.npy",
            "--label_volumes", f"v:{dataset}/data.h5:seg",
            "--model_args", ARGS, "--batch_size", "2", "--image_mean", "128",
            "--image_stddev", "33", "--train_dir", str(train_dir),
            "--max_steps", "3", "--summary_every_steps", "3", *extra]


def test_cli_trains_on_the_cpu(dataset, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ffn_tpu_torch.cli.train",
         *cli_args(dataset, tmp_path, "--device", "cpu")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "extra.ckpt-3.npz", "model.ckpt-3.npz", "opt.ckpt-3.npz"]
    with open(tmp_path / "summaries.jsonl") as f:
        assert json.loads(f.readline())["step"] == 3


def test_cli_refuses_cuda_without_a_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(cli_args(dataset, tmp_path, "--device", "cuda"))


@pytest.mark.parametrize("flags", [
    ["--trainer", "host_loop", "--precision", "bf16"],
    ["--fov_policy", "max_pred_moves"], ["--fov_policy", "no_step"],
    ["--precision", "bf16"], ["--precision", "f16"], ["--remat"],
    ["--coordinator_address", "localhost:1234", "--num_processes", "2",
     "--process_id", "0"]])
def test_cli_refuses_unported_options(dataset, tmp_path, flags):
    # --precision bf16 and f16 train on both trainers: a 2-step run of the
    # port's CLI against the JAX CLI's. The scan trainer refuses the
    # data-dependent policies as the JAX package does (they run on
    # --trainer host_loop); the rest is not ported to either trainer.
    if "--precision" in flags:
        return _cli_matches_jax_cli(dataset, tmp_path, flags)
    match = ("Use run_training_host_loop" if "--fov_policy" in flags
             else "ROADMAP")
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main(cli_args(dataset, tmp_path, "--device", "cpu",
                                *flags))


# The port resumed from the JAX CLI's step-1 checkpoint against the JAX
# CLI's step 2 (for the host loop, the JAX CLI resumed from the same
# checkpoint, at batch 1: the examples in flight are not saved): weights
# within LOWP_ATOL of the step's largest parameter change and biases within
# LOWP_BIAS_ATOL (measured: weights equal; biases 0.20 bf16, 0.019 f16,
# 1.5e-6 host loop: XLA's CPU backend sums a bias gradient in 16 bits,
# test_torch_precision.py), the data cursor, the shuffle RNG (scan) and the
# f16 loss scale (scale0, scale1) equal. The JAX CLI runs in a subprocess
# with --xla_allow_excess_precision=false.
LOWP_ATOL, LOWP_BIAS_ATOL = 2.0 ** -10, 0.4


def _jax_cli(dataset, train_dir, flags, steps):
    args = ["--train_coords", str(dataset / "coords.npz"),
            "--data_volumes", f"v:{dataset}/data.h5:img",
            "--label_volumes", f"v:{dataset}/data.h5:seg",
            "--model_args", ARGS, "--batch_size", "2", "--image_mean", "128",
            "--image_stddev", "33", "--train_dir", str(train_dir),
            "--max_steps", str(steps), "--checkpoint_every_steps", "1",
            "--summary_every_steps", "2", *flags]
    proc = subprocess.run(
        [sys.executable, "-m", "ffn_tpu.cli.train", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_allow_excess_precision=false"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _copy_ckpt(src, dst, step):
    os.makedirs(dst / "ckpt")
    for prefix in ("model", "opt", "extra"):
        shutil.copy(src / "ckpt" / f"{prefix}.ckpt-{step}.npz", dst / "ckpt")


def _cli_matches_jax_cli(dataset, tmp_path, flags):
    host = "--trainer" in flags
    flags = flags + (["--batch_size", "1"] if host else [])
    _jax_cli(dataset, tmp_path / "jax", flags, 1 if host else 2)
    want = tmp_path / "jax"
    if host:
        want = tmp_path / "jax_resumed"
        _copy_ckpt(tmp_path / "jax", want, 1)
        _jax_cli(dataset, want, flags, 2)
    port = tmp_path / "port"
    _copy_ckpt(tmp_path / "jax", port, 1)
    train_cli.main(cli_args(dataset, port, "--device", "cpu", *flags,
                            "--max_steps", "2", "--checkpoint_every_steps",
                            "1"))
    before, got, ref = (load(d, "model", s) for d, s in (
        (tmp_path / "jax", 1), (port, 2), (want, 2)))
    moved = max(np.abs(ref[k] - before[k]).max() for k in ref)
    assert sorted(got) == sorted(ref) and moved > 0
    for k in ref:
        tol = LOWP_BIAS_ATOL if k.endswith("bias") else LOWP_ATOL
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol * moved,
                                   err_msg=k)
    x, y = load(port, "extra", 2), load(want, "extra", 2)
    assert sorted(x) == sorted(y)
    assert ("scale0" in y) == ("f16" in flags)
    if "f16" in flags:   # and the JAX package restores the port's scale
        _, scale, _ = jax_train_loop._restore_extra(
            str(port / "ckpt"), 2, None,
            jax_precision.DynamicLossScale.init(), np.random.RandomState(0))
        assert [np.asarray(v) for v in jax.tree.leaves(scale)] == [
            x["scale0"], x["scale1"]]
    for k in x:
        # The host loop's saved augmentation RNG depends on how far its
        # prefetch thread had drawn (ROADMAP Queue 3).
        if not (host and k.startswith("rng")):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert x[k].dtype == y[k].dtype, k


def test_training_restores_signal_handlers(dataset, init_params, tmp_path):
    # A finished run leaves SIGTERM/SIGINT as it found them, so a process
    # that trains and then goes on (chip_smoke.py) still stops on SIGTERM.
    import signal
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    port_run(dataset, tmp_path / "signals", 1, init_params)
    assert [signal.getsignal(s) for s in (signal.SIGTERM,
                                          signal.SIGINT)] == before
