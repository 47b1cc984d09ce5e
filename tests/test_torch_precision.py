"""The port's reduced-precision training pieces against the JAX package's on
the CPU: the loss-scale state, K12's plain version with the scale, and
16-bit layers' gradients (K15's plain forward, K17's and K18's plain
backward). JAX runs op by op (jax.vjp outside jit), so each 16-bit value
is rounded where the jaxpr says. XLA's CPU backend sums a 16-bit
reduce_sum (a bias gradient) in 16 bits element by element (measured), the
port in float32 with one rounding; the one-layer cases use coarse grids on
which every float32 sum is exact and the 16-bit bias sums never round, so
they agree.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import params_io as jax_params_io
from ffn_tpu.training import optimizer as jax_optimizer
from ffn_tpu.training import precision as jax_precision
from ffn_tpu_torch.models import convstack_3d
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops import conv3d
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import precision as precision_lib

torch.set_num_threads(1)   # six test workers share the CPU

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
MODEL = dict(fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)


def test_policies_and_loss_scale_init_match_jax():
    for name in ("f32", "bf16", "f16"):
        jp, tp = jax_precision.get_policy(name), precision_lib.get_policy(
            name)
        assert jp.use_loss_scale == tp.use_loss_scale
        assert np.dtype(jp.compute_dtype).name == str(
            tp.compute_dtype).split(".")[1]
        ja = jax_precision.loss_scale_for(jp)
        ta = precision_lib.loss_scale_for(tp)
        assert [np.asarray(x) for x in jax.tree.leaves(ja)] == [
            t.numpy() for t in ta.leaves()]
        assert float(ja.scale) == float(ta.scale)
    with pytest.raises(ValueError):
        precision_lib.get_policy("f64")


def test_dynamic_loss_scale_matches_jax():
    # Growth after growth_interval = 3 finite steps, halving on a
    # non-finite one, the floor at 1, from 4.
    finite = [1, 1, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1]
    js = jax_precision.DynamicLossScale.init(4.0, growth_interval=3)
    ts = precision_lib.DynamicLossScale.init(4.0, growth_interval=3)
    seen = set()
    for f in finite:
        js, ts = js.adjust(jnp.bool_(f)), ts.adjust(torch.tensor(bool(f)))
        assert ts.scale.dtype == torch.float32
        assert ts.counter.dtype == torch.int32
        assert (float(js.scale), int(js.counter)) == (float(ts.scale),
                                                       int(ts.counter))
        seen.add(float(ts.scale))
    assert {1.0, 8.0} <= seen   # the floor and a growth were reached
    loss = np.float32(0.3)
    assert float(js.scale_loss(jnp.float32(loss))) == float(
        ts.scale_loss(torch.tensor(loss)))
    g = np.random.RandomState(0).randn(5).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(js.unscale(jnp.asarray(g))),
        ts.unscale([torch.from_numpy(g)])[0].numpy())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("bad", [None, "inf", "nan"])
def test_k12_plain_with_the_scale_matches_jax(optimizer, bad):
    # The scan body with a DynamicLossScale (train_lib.py:368-384): unscale,
    # all_finite, adjust, tx.update, the gated update, select_tree; gradients
    # as a scaled backward pass leaves them, an inf or a NaN in one entry.
    # sgd bit for bit; adam within 1e-6 (a last-digit difference in 1 of 216
    # entries: XLA fuses adam's float32 arithmetic, as in
    # test_torch_train.py::test_k12_plain_matches_optax).
    tol = 1e-6 if optimizer == "adam" else 0.0
    rng = np.random.RandomState(7)
    opt_kw = dict(optimizer=optimizer, learning_rate=0.05)
    tx = jax_optimizer.optimizer_from_config(
        jax_optimizer.OptimizerConfig(**opt_kw))
    opt = optimizer_lib.Optimizer(optimizer_lib.OptimizerConfig(**opt_kw))
    shapes = {"conv0_a": (3, 3, 3, 2, 4), "conv_lom": (1, 1, 1, 4, 1)}
    params = {"params": {n: {"kernel": rng.randn(*s).astype(np.float32),
                             "bias": rng.randn(s[-1]).astype(np.float32)}
                         for n, s in shapes.items()}}
    jp = jax.tree.map(jnp.asarray, params)
    jo = tx.init(jp)
    js = jax_precision.DynamicLossScale.init(2.0 ** 15, growth_interval=2)
    tp = {f"{n}.{leaf}": torch.from_numpy(params["params"][n][
        {"weight": "kernel"}.get(leaf, leaf)].copy())
        for n in shapes for leaf in ("weight", "bias")}
    ts = opt.init(tp)
    tscale = precision_lib.DynamicLossScale.init(2.0 ** 15,
                                                 growth_interval=2)
    for step in range(4):
        g = jax.tree.map(lambda a: (rng.randn(*a.shape) * 2.0 ** 15).astype(
            np.float32), params)
        if bad and step == 1:
            g["params"]["conv_lom"]["kernel"][0, 0, 0, 2, 0] = float(bad)
        jg = js.unscale(jax.tree.map(jnp.asarray, g))
        finite = jax_precision.all_finite(jg)
        js = js.adjust(finite)
        updates, new = tx.update(jg, jo, jp)
        updates = jax.tree.map(lambda u: jnp.where(finite, u, 0.0), updates)
        jp = optax.apply_updates(jp, updates)
        jo = jax_precision.select_tree(finite, new, jo)

        flat = params_io._flatten(g)
        finite_out = torch.tensor(False)
        opt.update(tp, [torch.from_numpy(flat[params_io.jax_name(n)])
                        for n in tp], ts, None, torch.tensor(1.0),
                   finite_out, loss_scale=tscale)
        assert bool(finite_out) == bool(finite)
        assert (float(tscale.scale), int(tscale.counter)) == (
            float(js.scale), int(js.counter))
        jflat = params_io._flatten(jax.tree.map(np.asarray, jp))
        for n, t in tp.items():
            np.testing.assert_allclose(t.numpy(), jflat[params_io.jax_name(
                n)], rtol=tol, atol=tol)
        for a, b in zip(opt.leaves(ts), jax.tree.leaves(jo)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)
    assert float(tscale.scale) == 2.0 ** (15 if bad else 17)


LAYERS = {   # (k, Cin, Cout, pre_relu, post_relu, residual: None/16/32)
    "conv0_a": (3, 2, 4, False, True, None),
    "block_a": (3, 4, 4, True, True, None),
    "block_b": (3, 4, 4, False, False, 16),
    "conv_lom": (1, 4, 1, True, False, 32),
}


@pytest.mark.parametrize("case", list(LAYERS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_gradients_match_jax_vjp(case, dtype):
    jdt, tdt = DTYPES[dtype]
    k, cin, cout, pre, post, res = LAYERS[case]
    rng = np.random.RandomState(17)
    shape = (2, 7, 8, 9)
    # Coarse grids: every product and float32 sum is exact, and every
    # partial sum of dy stays exact in 8 significant bits.
    x = (rng.randint(-8, 9, shape + (cin,)) / 8).astype(np.float32)
    w = (rng.randint(-8, 9, (k,) * 3 + (cin, cout)) / 64).astype(np.float32)
    b = (rng.randint(-8, 9, cout) / 16).astype(np.float32)
    r = (rng.randint(-8, 9, shape + (cout,)) / 8).astype(np.float32)
    dy = (rng.randint(-2, 3, shape + (cout,)) / 1024).astype(np.float32)
    assert np.abs(np.cumsum(dy.reshape(-1, cout), 0)).max() < 0.25
    layer = nn.Conv(cout, (k,) * 3, padding="SAME", dtype=jdt,
                    precision=None)
    x_in = x if case == "conv0_a" else x.astype(jdt)
    r_in = r if res == 32 else r.astype(jdt)

    def f(x, kernel, bias):
        h = x.astype(jdt)
        h = jax.nn.relu(h) if pre else h
        y = layer.apply({"params": {"kernel": kernel, "bias": bias}}, h)
        y = jax.nn.relu(y) if post else y
        if res == 32:
            return y.astype(jnp.float32) + r_in
        return y + r_in if res else y

    y, vjp = jax.vjp(f, jnp.asarray(x_in), w, b)
    dy_in = jnp.asarray(dy).astype(y.dtype)
    dx_j, dw_j, db_j = vjp(dy_in)

    tx = torch.tensor(np.asarray(jnp.asarray(x_in).astype(
        jnp.float32))).to(torch.float32 if case == "conv0_a" else tdt)
    tdy = torch.tensor(np.asarray(dy_in.astype(jnp.float32))).to(
        torch.float32 if res == 32 else tdt)
    tw = torch.from_numpy(w).to(tdt)
    ty = conv3d.conv3d_ndhwc_bf16(
        tx, tw, torch.from_numpy(b).to(tdt), pre_relu=pre, post_relu=post,
        residual=None if res is None else torch.from_numpy(r_in.astype(
            np.float32)).to(torch.float32 if res == 32 else tdt))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    ym = ty if post else None
    dw, db = conv3d.conv3d_wgrad_16(tx, tdy, k, pre_relu=pre, y=ym)
    np.testing.assert_array_equal(dw.numpy(), np.asarray(dw_j))
    np.testing.assert_array_equal(db.numpy(), np.asarray(db_j))
    if case != "conv0_a":
        dx = conv3d.conv3d_dgrad_16(tdy, tw, x=tx if pre else None, y=ym)
        assert dx.dtype == tdt
        np.testing.assert_array_equal(dx.float().numpy(), np.asarray(
            dx_j.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stack_gradients_match_jax_vjp(dtype):
    # The depth-2 stack (conv0_a, conv0_b, one residual block, conv_lom) on
    # 16-bit autograd Functions against jax.vjp of model.apply, f16 with
    # the initial loss scale on the cotangent. Logits and weight gradients
    # agree within 2^-10 of their largest (measured: bfloat16 bit for bit;
    # float16 2.7e-4, from float32 sums of 22-bit products taken in other
    # orders); bias gradients within a quarter of their largest, since
    # XLA's CPU backend sums them in 16 bits element by element (measured
    # 0.24 in bfloat16, 0.031 in float16), the port in float32.
    jdt, tdt = DTYPES[dtype]
    jm = jax_convstack.ConvStack3DFFNModel(**MODEL, dtype=jdt,
                                           precision=None)
    params = jax.tree.map(np.asarray, jm.init_params(None))
    rng = np.random.RandomState(1)
    img = rng.randn(2, 9, 9, 9, 1).astype(np.float32)
    seed = (rng.randn(2, 9, 9, 9, 1) * 2).astype(np.float32)
    scale = 2.0 ** 15 if dtype == "f16" else 1.0
    ct = (rng.randn(2, 9, 9, 9, 1) * 1e-3 * scale).astype(np.float32)
    out, vjp = jax.vjp(lambda p: jm.apply(p, img, seed), params)
    want = jax_params_io._flatten(jax.tree.map(np.asarray,
                                               vjp(jnp.asarray(ct))[0]))
    model = convstack_3d.ConvStack3DFFNModel(**MODEL, dtype=dtype.replace(
        "bf16", "bfloat16").replace("f16", "float16"))
    model.load_params(params)
    net = torch.from_numpy(np.concatenate([img, seed], -1))
    logits = model.train_apply(net, torch.from_numpy(seed))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(out),
                               rtol=0, atol=2.0 ** -10 * np.abs(out).max())
    named = dict(model.module.named_parameters())
    grads = torch.autograd.grad(logits, list(named.values()),
                                torch.from_numpy(ct))
    for (name, _), g in zip(named.items(), grads):
        w = want[params_io.jax_name(name)]
        tol = (0.25 if name.endswith("bias") else 2.0 ** -10) * np.abs(
            w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
    # The 16-bit copies follow the parameters once training has run.
    with torch.no_grad():
        model.module.conv0_a.weight.add_(1.0)
    model.apply(torch.from_numpy(img), torch.from_numpy(seed))
    assert torch.equal(model.module.conv0_a.weight16,
                       model.module.conv0_a.weight.to(tdt))
