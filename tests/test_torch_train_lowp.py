"""The port's train steps in bfloat16 and float16 (--precision bf16, f16)
against the JAX package's, on the CPU: test_torch_train.py's model and
JAX initial parameters (conv_lom raised) through one packed scan step (27
offsets) and one FOV step with config in both packages, f16 with the
DynamicLossScale, bf16 with none. The JAX steps are jitted (XLA keeps some
16-bit intermediates in float32 and sums bias gradients in 16 bits,
test_torch_precision.py), so the loss scale, its counter, grads_finite and
counts equal, losses and parameters within TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import params_io as jax_params_io
from ffn_tpu.training import optimizer as jax_optimizer
from ffn_tpu.training import precision as jax_precision
from ffn_tpu.training import train_lib as jax_train_lib
from ffn_tpu_torch.inference import runner as runner_lib
from ffn_tpu_torch.models import convstack_3d
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import train_lib

torch.set_num_threads(1)   # six test workers share the CPU

MODEL = dict(fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
B, C = 2, 13
DTYPES = {"bf16": (jnp.bfloat16, "bfloat16"), "f16": (jnp.float16,
                                                       "float16")}
# (loss relative; weights, biases absolute against the largest change of
# any parameter in the step), measured: scan bf16 0.024, 0.022, 0.48; f16
# 0.0010, 0.00081, 0.034; FOV bf16 4.2e-4, 1.4e-4, 0.17; f16 0, 3.8e-7,
# 0.024. The bias gradients' 16-bit sums in XLA move the biases (and in 27
# offsets the forward passes that follow) most.
TOL = {("scan", "bf16"): (0.05, 0.05, 1.0), ("scan", "f16"): (2e-3, 2e-3, 0.1),
       ("fov", "bf16"): (1e-3, 3e-4, 0.4), ("fov", "f16"): (1e-6, 1e-6, 0.05)}


@pytest.fixture(scope="module")
def init_params():
    params = jax.tree.map(np.asarray, jax_convstack.ConvStack3DFFNModel(
        **MODEL).init_params(None))
    lom = params["params"]["conv_lom"]
    lom["bias"] = np.full((1,), 5.2, np.float32)
    lom["kernel"] = lom["kernel"] * np.float32(100.0)
    return params


def batch():
    rng = np.random.RandomState(0)
    image_u8 = rng.randint(0, 256, (B, C, C, C, 1)).astype(np.uint8)
    zz, yy, xx = np.meshgrid(*(np.arange(C),) * 3, indexing="ij")
    lom = []
    for b in range(B):
        c = np.array([6, 6, 6]) + rng.randint(-2, 3, 3)
        lom.append((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
                   <= (4 + b) ** 2)
    return image_u8, np.stack(lom)[..., None].astype(np.uint8)


def models(precision, init_params, scale=None, lr=0.01):
    """(JAX model, tx, params, opt_state, scale state, config), (port
    model, state, opt, config), the same settings."""
    jdt, tdt = DTYPES[precision]
    base = dict(fov_size=(9,) * 3, deltas=(2,) * 3, depth=2, features=4,
                batch_size=B, precision=precision)
    opt_kw = dict(optimizer="sgd", learning_rate=lr)
    jcfg = jax_train_lib.TrainConfig(
        **base, optimizer=jax_optimizer.OptimizerConfig(**opt_kw))
    tcfg = train_lib.TrainConfig(
        **base, optimizer=optimizer_lib.OptimizerConfig(**opt_kw))
    jm = jax_convstack.ConvStack3DFFNModel(**MODEL, dtype=jdt, precision=None)
    tx = jax_optimizer.optimizer_from_config(jcfg.optimizer)
    params = jax.tree.map(jnp.asarray, init_params)
    js = jax_precision.loss_scale_for(jax_precision.get_policy(precision))
    tm = convstack_3d.ConvStack3DFFNModel(**MODEL, dtype=tdt)
    tm.load_params(init_params)
    state, opt = train_lib.create_train_state(tm, tcfg)
    if scale is not None:
        js = jax_precision.DynamicLossScale.init(scale)
        state.scale_state.scale.fill_(scale)
    return ((jm, tx, params, tx.init(params), js, jcfg),
            (tm, state, opt, tcfg))


def assert_close(tol, jparams, init_params, tparams, jloss, tloss):
    loss_rtol, weight_tol, bias_tol = tol
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=loss_rtol,
                               atol=1e-7)
    want = jax_params_io._flatten(jax.tree.map(np.asarray, jparams))
    init = jax_params_io._flatten(init_params)
    moved = max(np.abs(want[k] - init[k]).max() for k in want)
    assert moved > 0
    for name, t in tparams.items():
        key = params_io.jax_name(name)
        tol = bias_tol if name.endswith("bias") else weight_tol
        np.testing.assert_allclose(t.detach().numpy(), want[key], rtol=0,
                                   atol=tol * moved, err_msg=name)


@pytest.mark.parametrize("precision", list(DTYPES))
def test_scan_step_matches_jax(init_params, precision):
    (jm, tx, params, opt_state, js, jcfg), (tm, state, opt, tcfg) = models(
        precision, init_params)
    image_u8, lom_u8 = batch()
    offsets = jax_train_lib.fixed_offsets_zyx(jm.info)
    step = jax_train_lib.make_scan_train_step_packed(jm, tx, jcfg)
    params, _, _, js, jmet = step(params, opt_state, None, js,
                                  jnp.asarray(image_u8), jnp.asarray(lom_u8),
                                  jnp.asarray(offsets))
    tstep = train_lib.make_scan_train_step_packed(tm, opt, tcfg)
    state, tmet = tstep(state, torch.from_numpy(image_u8),
                        torch.from_numpy(lom_u8), offsets)
    for k in ("active", "correct", "missed", "spurious", "grads_finite",
              "loss_scale"):
        np.testing.assert_array_equal(tmet[k].numpy(), np.asarray(jmet[k]),
                                      err_msg=k)
    assert [np.asarray(x) for x in jax.tree.leaves(js)] == [
        t.numpy() for t in state.scale_state.leaves()]
    if precision == "f16":
        # The crafted conv_lom overflows float16 at 2^15: some offsets
        # skip and halve the scale, as in JAX.
        assert not tmet["grads_finite"].all() and tmet["grads_finite"].any()
    assert_close(TOL["scan", precision], params, init_params, state.params,
                 jmet["loss"], tmet["loss"].numpy())


@pytest.mark.parametrize("precision", list(DTYPES))
def test_fov_step_matches_jax(init_params, precision):
    (jm, tx, params, opt_state, js, jcfg), (tm, state, opt, tcfg) = models(
        precision, init_params, scale=2.0 ** 10 if precision == "f16"
        else None)
    rng = np.random.RandomState(5)
    seed = (rng.randn(B, 9, 9, 9, 1) * 2).astype(np.float32)
    image = rng.randn(B, 9, 9, 9, 1).astype(np.float32)
    labels = rng.choice([0.05, 0.95], (B, 9, 9, 9, 1)).astype(np.float32)
    weights = rng.rand(B, 9, 9, 9, 1).astype(np.float32)
    step = jax_train_lib.make_fov_train_step(jm, tx, config=jcfg)
    params, _, _, js, jlogits, jloss = step(params, opt_state, None, js,
                                            seed, image, labels, weights)
    tstep = train_lib.make_fov_train_step(tm, opt, config=tcfg)
    _, _, _, ts, tlogits, tloss = tstep(
        state.params, state.opt_state, None, state.scale_state,
        *(torch.from_numpy(a) for a in (seed, image, labels, weights)))
    assert [np.asarray(x) for x in jax.tree.leaves(js)] == [
        t.numpy() for t in ts.leaves()]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=2.0 ** -7 * np.abs(
                                   np.asarray(jlogits)).max())
    assert_close(TOL["fov", precision], params, init_params, state.params,
                 jloss, float(tloss))


def test_f16_overflow_skips_the_step(init_params):
    # From a scale of 2^40 the scaled cotangent overflows float16: both
    # packages skip every update, halve the scale at each offset and keep
    # the parameters bit for bit.
    (jm, tx, params, opt_state, js, jcfg), (tm, state, opt, tcfg) = models(
        "f16", init_params, scale=2.0 ** 40)
    image_u8, lom_u8 = batch()
    offsets = jax_train_lib.fixed_offsets_zyx(jm.info)[:4]
    step = jax_train_lib.make_scan_train_step_packed(jm, tx, jcfg)
    jp, _, _, js, jmet = step(params, opt_state, None, js,
                              jnp.asarray(image_u8), jnp.asarray(lom_u8),
                              jnp.asarray(offsets))
    tstep = train_lib.make_scan_train_step_packed(tm, opt, tcfg)
    state, tmet = tstep(state, torch.from_numpy(image_u8),
                        torch.from_numpy(lom_u8), offsets)
    assert not np.asarray(jmet["grads_finite"]).any()
    np.testing.assert_array_equal(tmet["grads_finite"].numpy(),
                                  np.asarray(jmet["grads_finite"]))
    np.testing.assert_array_equal(tmet["loss_scale"].numpy(),
                                  2.0 ** np.arange(39, 35, -1))
    np.testing.assert_array_equal(np.asarray(jmet["loss_scale"]),
                                  2.0 ** np.arange(39, 35, -1))
    flat = jax_params_io._flatten(init_params)
    jflat = jax_params_io._flatten(jax.tree.map(np.asarray, jp))
    for name, t in state.params.items():
        key = params_io.jax_name(name)
        np.testing.assert_array_equal(t.detach().numpy(), flat[key])
        np.testing.assert_array_equal(jflat[key], flat[key])


def test_runner_refuses_float16_inference(tmp_path):
    from ffn_tpu_torch.inference.settings import InferenceSettings
    settings = InferenceSettings(
        image=str(tmp_path / "none.npy"), model_name="convstack_3d.ConvStack3DFFNModel",
        model_args='{"depth": 2, "features": 4, "fov_size": [9, 9, 9], '
                   '"deltas": [2, 2, 2], "dtype": "float16"}',
        segmentation_output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner_lib.Runner(device="cpu").start(settings)
