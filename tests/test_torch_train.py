"""The port's scan train steps against the JAX package's, on the CPU.

The same numpy inputs and JAX initial parameters (conv_lom raised so
lanes pass the move gate off the centre) through both packages' steps: 9^3
FOV, deltas 2 (13^3 canvas, 27 offsets), depth 2, 4 features, batch 2.
Counts equal; per-offset loss within 1e-5 relative, `patch_loss` 1e-4
(an eval-region mean summed in another order: 1.4e-5 measured);
parameters, optimizer state, EMA within 1e-5 (measured 9.5e-7 weights,
4.3e-6 in sums of gradients); the explicit step's seeds within 1e-5
absolute plus 1e-5 relative (1.05e-5 at a logit of 4.1). Also each
kernel's plain version against the JAX function it replaces (K9/K10 vs
jax.vjp, K11 vs the scan body, K12 vs optax), the optimizer leaf order,
and the options the port refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.special import logit

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.training import optimizer as jax_optimizer
from ffn_tpu.training import precision as jax_precision
from ffn_tpu.training import train_lib as jax_train_lib
from ffn_tpu.training import train_loop as jax_train_loop
from ffn_tpu_torch.models import convstack_3d
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops import conv3d
from ffn_tpu_torch.ops import optim as optim_ops
from ffn_tpu_torch.ops import train as train_ops
from ffn_tpu_torch.training import optimizer as optimizer_lib
from ffn_tpu_torch.training import precision as precision_lib
from ffn_tpu_torch.training import train_lib

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

MODEL = dict(fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=4)
CANVAS = (13, 13, 13)
B = 2
# conv_lom's bias raised and its kernel scaled up: after the centre update
# the seeds at the other offsets sit around the move gate, so some pass it
# and some do not.
LOM_BIAS, LOM_SCALE = 5.2, 100.0
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
PATCH_RTOL = 1e-4
SEED_RTOL = 1e-5
COUNTS = ("active", "correct", "missed", "spurious")


def configs(optimizer="sgd", lr=0.01, **kw):
    """(JAX TrainConfig, port TrainConfig) of the same settings."""
    opt_kw = dict(optimizer=optimizer, learning_rate=lr)
    opt_kw.update(kw.pop("opt", {}))
    base = dict(fov_size=(9, 9, 9), deltas=(2, 2, 2), depth=2, features=4,
                batch_size=B)
    base.update(kw)
    return (jax_train_lib.TrainConfig(
                **base, optimizer=jax_optimizer.OptimizerConfig(**opt_kw)),
            train_lib.TrainConfig(
                **base, optimizer=optimizer_lib.OptimizerConfig(**opt_kw)))


@pytest.fixture(scope="module")
def init_params():
    model = jax_convstack.ConvStack3DFFNModel(**MODEL)
    params = jax.tree.map(np.asarray, model.init_params(None))
    lom = params["params"]["conv_lom"]
    lom["bias"] = np.full((1,), LOM_BIAS, np.float32)
    lom["kernel"] = lom["kernel"] * np.float32(LOM_SCALE)
    return params


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    image_u8 = rng.randint(0, 256, (B, *CANVAS, 1)).astype(np.uint8)
    # A blob per lane around the centre, so wanted moves exist.
    zz, yy, xx = np.meshgrid(*(np.arange(13),) * 3, indexing="ij")
    lom = []
    for b in range(B):
        c = np.array([6, 6, 6]) + rng.randint(-2, 3, 3)
        r = 4 + b
        lom.append((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
                   <= r * r)
    lom_u8 = np.stack(lom)[..., None].astype(np.uint8)
    return image_u8, lom_u8


def jax_state(config, params):
    model = jax_convstack.ConvStack3DFFNModel(**MODEL)
    tx = jax_optimizer.optimizer_from_config(config.optimizer)
    params = jax.tree.map(jnp.asarray, params)
    ema = (jax.tree.map(jnp.array, params) if config.ema_decay > 0
           else None)
    return model, tx, params, tx.init(params), ema


def port_state(config, params):
    model = convstack_3d.ConvStack3DFFNModel(**MODEL)
    model.load_params(params)
    state, opt = train_lib.create_train_state(model, config)
    return model, state, opt


def assert_params_close(jax_params, state, atol=PARAM_ATOL):
    flat = params_io._flatten(jax.tree.map(np.asarray, jax_params))
    for name, t in state.params.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   flat[params_io.jax_name(name)],
                                   atol=atol, rtol=0, err_msg=name)


def assert_opt_close(jax_opt_state, opt, port_opt_state, atol=PARAM_ATOL):
    want = [np.asarray(x) for x in jax.tree.leaves(jax_opt_state)]
    got = opt.leaves(port_opt_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=str(i))


def assert_metrics_match(jm, tm, packed=True):
    for k in COUNTS:
        np.testing.assert_array_equal(np.asarray(jm[k]), tm[k].numpy(), k)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(jm["grads_finite"]),
                                  tm["grads_finite"].numpy())
    if packed:
        for k in ("tp", "fp", "fn", "tn"):
            assert int(jm[k]) == int(tm[k]), k
        np.testing.assert_allclose(float(tm["patch_loss"]),
                                   float(jm["patch_loss"]), rtol=PATCH_RTOL)


def run_packed(optimizer, init_params, batch, **kw):
    jcfg, tcfg = configs(optimizer, **kw)
    jmodel, tx, params, opt_state, ema = jax_state(jcfg, init_params)
    offsets = jax_train_lib.fixed_offsets_zyx(jmodel.info)
    image_u8, lom_u8 = batch
    step = jax_train_lib.make_scan_train_step_packed(jmodel, tx, jcfg)
    scale = jax_precision.NoOpLossScale()
    params, opt_state, ema, _, jm = step(
        params, opt_state, ema, scale, jnp.asarray(image_u8),
        jnp.asarray(lom_u8), jnp.asarray(offsets))

    tmodel, state, opt = port_state(tcfg, init_params)
    tstep = train_lib.make_scan_train_step_packed(tmodel, opt, tcfg)
    state, tm = tstep(state, torch.from_numpy(image_u8),
                      torch.from_numpy(lom_u8), offsets)
    return (params, opt_state, ema, jm), (state, opt, tm)


@pytest.mark.parametrize("optimizer",
                         ["momentum", "adam", "sgd", "adagrad", "rmsprop"])
def test_packed_step_matches_jax(init_params, batch, optimizer):
    (params, opt_state, _, jm), (state, opt, tm) = run_packed(
        optimizer, init_params, batch)
    active = tm["active"].numpy()
    # The gate passes off the centre and fails at other offsets: both the
    # update and the no-update branch ran.
    assert active[0] == B and (active[1:] > 0).any() and \
        (active[1:] == 0).any()
    assert_metrics_match(jm, tm)
    assert_params_close(params, state)
    assert_opt_close(opt_state, opt, state.opt_state)


def test_packed_step_with_ema_and_schedule_matches_jax(init_params, batch):
    # decay_steps 3: the rate halves within the one step (27 offsets).
    (params, opt_state, ema, jm), (state, opt, tm) = run_packed(
        "momentum", init_params, batch, lr=0.05, ema_decay=0.9,
        opt=dict(learning_rate_decay_factor=0.5, decay_steps=3))
    assert_metrics_match(jm, tm)
    assert_params_close(params, state)
    assert_opt_close(opt_state, opt, state.opt_state)
    count = int(opt.leaves(state.opt_state)[-1])
    assert count == int((tm["active"].numpy() > 0).sum()) > 3
    flat = params_io._flatten(jax.tree.map(np.asarray, ema))
    for name, t in state.ema_params.items():
        np.testing.assert_allclose(t.numpy(), flat[params_io.jax_name(name)],
                                   atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("optimizer", optim_ops.OPTIMIZERS)
def test_fixed_window_step_matches_jax(init_params, batch, optimizer):
    (params, opt_state, _, jm), (state, opt, tm) = run_packed(
        optimizer, init_params, batch, fov_policy="fixed_window",
        fixed_window_radius=2)
    assert_metrics_match(jm, tm)
    assert_params_close(params, state)
    assert_opt_close(opt_state, opt, state.opt_state)


def explicit_inputs(rng, nan=False):
    seeds = jax_train_lib.make_seed_canvas(B, CANVAS, 0.05, 0.95)
    # Lane 0 passes the gate at a few shell offsets, lane 1 only at the
    # centre.
    for off in [(2, 0, 0), (0, -2, 2), (-2, 2, -2)]:
        seeds[(0,) + tuple(6 + v for v in off)] = 3.0
    images = rng.randn(B, *CANVAS, 1).astype(np.float32)
    if nan:
        images[0, 6, 6, 6, 0] = np.nan
    labels = np.where(rng.rand(B, *CANVAS, 1) > 0.4, 0.95,
                      0.05).astype(np.float32)
    weights = rng.rand(B, *CANVAS, 1).astype(np.float32)
    return seeds, images, labels, weights


@pytest.mark.parametrize("optimizer,nan", [
    (o, False) for o in optim_ops.OPTIMIZERS] + [("adam", True)])
def test_explicit_step_matches_jax(init_params, optimizer, nan):
    jcfg, tcfg = configs(optimizer, packed_transfers=False)
    jmodel, tx, params, opt_state, ema = jax_state(jcfg, init_params)
    offsets = jax_train_lib.fixed_offsets_zyx(jmodel.info)
    seeds, images, labels, weights = explicit_inputs(
        np.random.RandomState(3), nan)
    step = jax_train_lib.make_scan_train_step(jmodel, tx, jcfg)
    params, opt_state, _, _, jseeds, jm = step(
        params, opt_state, ema, jax_precision.NoOpLossScale(),
        jnp.asarray(seeds), jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(weights), jnp.asarray(offsets))

    tmodel, state, opt = port_state(tcfg, init_params)
    tstep = train_lib.make_scan_train_step(tmodel, opt, tcfg)
    state, tseeds, tm = tstep(state, torch.from_numpy(seeds.copy()),
                              torch.from_numpy(images),
                              torch.from_numpy(labels),
                              torch.from_numpy(weights), offsets)
    assert_metrics_match(jm, tm, packed=False)
    np.testing.assert_allclose(tseeds.numpy(), np.asarray(jseeds),
                               atol=PARAM_ATOL, rtol=SEED_RTOL)
    assert_params_close(params, state)
    assert_opt_close(opt_state, opt, state.opt_state)
    if nan:
        # The NaN reaches every gradient at the centre offset: no update
        # there (and no count), NaN logits written back for lane 0.
        assert not tm["grads_finite"][0] and tm["active"][0] > 0
        assert np.isnan(tseeds.numpy()[0, 6, 6, 6, 0])
    assert (tm["active"].numpy()[1:] > 0).any()


# -- each kernel's plain version against the JAX function it replaces ---------

CONV_CASES = {   # (k, Cin, Cout, pre_relu, post_relu, residual)
    "conv0_a": (3, 2, 6, False, True, False),
    "block_a": (3, 6, 6, True, True, False),
    "block_b": (3, 6, 6, False, False, True),
    "conv_lom": (1, 6, 1, True, False, True),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_k9_k10_plain_match_jax_vjp(case):
    import flax.linen as nn
    k, cin, cout, pre, post, res = CONV_CASES[case]
    rng = np.random.RandomState(9)
    x = rng.randn(2, 7, 8, 9, cin).astype(np.float32)
    w = (rng.randn(k, k, k, cin, cout) * 0.3).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    r = rng.randn(2, 7, 8, 9, cout).astype(np.float32)
    dy = rng.randn(2, 7, 8, 9, cout).astype(np.float32)
    layer = nn.Conv(cout, (k,) * 3, padding="SAME",
                    precision=jax.lax.Precision.HIGHEST)

    def f(x, kernel, bias):
        h = jax.nn.relu(x) if pre else x
        y = layer.apply({"params": {"kernel": kernel, "bias": bias}}, h)
        if post:
            y = jax.nn.relu(y)
        return y + r if res else y

    y, vjp = jax.vjp(f, x, w, b)
    dx_j, dw_j, db_j = vjp(jnp.asarray(dy))
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    ty = torch.from_numpy(np.array(y)) if post else None
    dx = conv3d.conv3d_dgrad_f32(tdy, torch.from_numpy(w),
                                 x=tx if pre else None, y=ty)
    dw, db = conv3d.conv3d_wgrad_f32(tx, tdy, k, pre_relu=pre, y=ty)
    for got, want in ((dx, dx_j), (dw, dw_j), (db, db_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_k11_plain_matches_scan_body_pieces():
    rng = np.random.RandomState(11)
    image_u8 = rng.randint(0, 256, (B, *CANVAS)).astype(np.uint8)
    lom_u8 = (rng.rand(B, *CANVAS) > 0.5).astype(np.uint8)
    pad, init = float(logit(0.05)), float(logit(0.95))
    images, labels, seeds = train_ops.train_prep(
        torch.from_numpy(image_u8), torch.from_numpy(lom_u8), CANVAS, 128.0,
        33.0, 0.05, pad, init)
    # train_lib.py:240-248.
    np.testing.assert_array_equal(
        images.numpy(), np.asarray((jnp.asarray(image_u8, jnp.float32)
                                    - 128.0) / 33.0))
    np.testing.assert_array_equal(labels.numpy(), np.where(
        lom_u8 > 0, np.float32(0.95), np.float32(0.05)))
    want = np.full((B, *CANVAS), np.float32(pad), np.float32)
    want[:, 6, 6, 6] = np.float32(init)
    np.testing.assert_array_equal(seeds.numpy(), want)

    seeds = torch.from_numpy((rng.randn(B, *CANVAS) * 3).astype(np.float32))
    move_t = float(logit(0.9))
    shell = jnp.asarray(train_ops.shell_zyx((2, 2, 2)))
    for off in [(0, 0, 0), (2, -2, 0), (-2, 2, 2)]:
        x_in, seed_patch, valid, wanted = train_ops.train_gather(
            seeds, images, labels, off, (9, 9, 9), move_t, 0.9)
        js = jnp.asarray(seeds.numpy())[..., None]
        start = (0,) + tuple(6 + o - 4 for o in off) + (0,)
        np.testing.assert_array_equal(
            seed_patch.numpy(), np.asarray(jax.lax.dynamic_slice(
                js, start, (B, 9, 9, 9, 1))))
        pos = (0,) + tuple(6 + o for o in off) + (0,)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(
            jax.lax.dynamic_slice(js, pos, (B, 1, 1, 1, 1)).reshape(B)
            >= move_t))
        np.testing.assert_array_equal(x_in[..., 1].numpy(),
                                      seed_patch[..., 0].numpy())
        # The fixed_window test (train_lib.py:326-335) off the centre.
        if any(off):
            _, _, wvalid, _ = train_ops.train_gather(
                seeds, images, labels, off, (9, 9, 9), move_t, 0.9,
                window=(1, (2, 2, 2)))
            pts = jnp.array([6, 6, 6])[None, :] + shell
            vals = js[:, pts[:, 0], pts[:, 1], pts[:, 2], 0]
            in_w = jnp.all(jnp.abs(shell - jnp.array(off)[None, :]) <= 1,
                           axis=1)
            np.testing.assert_array_equal(wvalid.numpy(), np.asarray(
                jnp.any((vals >= move_t) & in_w[None, :], axis=1)))

    # The loss, its gradient (jax.value_and_grad of :360-366 in the logits)
    # and the write-back (:392-401).
    logits = (rng.randn(B, 9, 9, 9, 1) * 3).astype(np.float32)
    lab = labels.numpy()[:, 2:11, 2:11, 2:11, None]
    w = rng.rand(B, *CANVAS).astype(np.float32)
    valid = torch.tensor([True, False])
    wanted = torch.tensor([True, True])
    metrics = torch.zeros(5)
    before = seeds.clone()
    dl = train_ops.train_loss(torch.from_numpy(logits), seeds, labels,
                              torch.from_numpy(w), valid, wanted, (0, 0, 0),
                              metrics, None)
    vf = jnp.asarray([1.0, 0.0])
    wp = jnp.asarray(w[:, 2:11, 2:11, 2:11, None])

    def loss_fn(x):
        ce = jax_train_lib.sigmoid_ce(x, jnp.asarray(lab)) * wp
        return (ce.mean(axis=(1, 2, 3, 4)) * vf).sum() / 1.0

    loss, grad = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    np.testing.assert_allclose(float(metrics[0]), float(loss), rtol=1e-6)
    np.testing.assert_allclose(dl.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(metrics[1:].numpy(), [1, 1, 1, 0])
    after = before.numpy().copy()
    after[0, 2:11, 2:11, 2:11] = logits[0, ..., 0]
    np.testing.assert_array_equal(seeds.numpy(), after)

    # The eval metrics (:255-266).
    patch_loss, counts = train_ops.train_eval(seeds, labels, (9, 9, 9), None)
    js = jnp.asarray(seeds.numpy())[:, 2:11, 2:11, 2:11]
    jl = jnp.asarray(labels.numpy())[:, 2:11, 2:11, 2:11]
    np.testing.assert_allclose(float(patch_loss), float(
        jax_train_lib.sigmoid_ce(js, jl).mean()), rtol=1e-5)
    pred, truth = js > 0, jl > 0.5
    np.testing.assert_array_equal(counts.numpy(), [
        int(jnp.sum(pred & truth)), int(jnp.sum(pred & ~truth)),
        int(jnp.sum(~pred & truth)), int(jnp.sum(~pred & ~truth))])


def test_k11_gradient_at_zero_matches_jax_grad():
    # jax.grad of the step's loss (train_lib.py:360-366) at logits of
    # exactly 0 and +-30: at 0 it is -w z / (V denom) (jnp.maximum splits
    # its tie 0.5/0.5 and abs' derivative at 0 is 1), not (0.5 - z) w.
    rng = np.random.RandomState(110)
    logits = (rng.randn(B, 9, 9, 9, 1) * 3).astype(np.float32)
    flat = logits.reshape(-1)
    flat[:9] = [0.0, 30.0, -30.0, 0.0, -0.0, 30.0, -30.0, 0.0, 0.0]
    flat[729:735] = [0.0, 30.0, -30.0, 0.0, 0.0, -0.0]
    labels = torch.from_numpy(rng.choice([0.05, 0.95], (B, *CANVAS))
                              .astype(np.float32))
    w = rng.rand(B, *CANVAS).astype(np.float32)
    seeds = torch.zeros((B, *CANVAS))
    valid = torch.tensor([True, True])
    dl = train_ops.train_loss(torch.from_numpy(logits), seeds, labels,
                              torch.from_numpy(w), valid, valid, (0, 0, 0),
                              torch.zeros(5), None)
    lab = jnp.asarray(labels.numpy()[:, 2:11, 2:11, 2:11, None])
    wp = jnp.asarray(w[:, 2:11, 2:11, 2:11, None])

    def loss_fn(x):
        ce = jax_train_lib.sigmoid_ce(x, lab) * wp
        return (ce.mean(axis=(1, 2, 3, 4)) * jnp.ones(B)).sum() / 2.0

    grad = np.asarray(jax.grad(loss_fn)(jnp.asarray(logits)))
    np.testing.assert_allclose(dl.numpy(), grad, rtol=1e-5, atol=1e-9)
    at0 = logits == 0
    np.testing.assert_allclose(
        dl.numpy()[at0], np.asarray(-wp * lab / (729 * 2.0))[at0],
        rtol=1e-6)


@pytest.mark.parametrize("optimizer", optim_ops.OPTIMIZERS)
@pytest.mark.parametrize("schedule", [False, True])
def test_k12_plain_matches_optax(optimizer, schedule):
    rng = np.random.RandomState(12)
    opt_kw = dict(optimizer=optimizer, learning_rate=0.05)
    if schedule:
        opt_kw.update(learning_rate_decay_factor=0.5, decay_steps=2)
    jcfg = jax_optimizer.OptimizerConfig(**opt_kw)
    tx = jax_optimizer.optimizer_from_config(jcfg)
    jsched = jax_optimizer.schedule_from_config(jcfg)
    tsched = optimizer_lib.schedule_from_config(
        optimizer_lib.OptimizerConfig(**opt_kw))
    for count in (0, 1, 2, 3, 7):
        want = jsched(count) if schedule else jsched
        got = tsched(count) if schedule else tsched
        assert np.float32(got) == np.float32(want), count
    shapes = {"conv0_a": (3, 3, 3, 2, 4), "conv_lom": (1, 1, 1, 4, 1)}
    params = {"params": {n: {"kernel": rng.randn(*s).astype(np.float32),
                             "bias": rng.randn(s[-1]).astype(np.float32)}
                         for n, s in shapes.items()}}
    jp = jax.tree.map(jnp.asarray, params)
    jo = tx.init(jp)
    je = jax.tree.map(jnp.array, jp)
    d = 0.9

    opt = optimizer_lib.Optimizer(optimizer_lib.OptimizerConfig(**opt_kw),
                                  ema_decay=d)
    tp = {f"{n}.{leaf}": torch.from_numpy(
              params["params"][n][{"weight": "kernel"}.get(leaf, leaf)]
              .copy())
          for n in shapes for leaf in ("weight", "bias")}
    ts = opt.init(tp)
    te = {n: t.clone() for n, t in tp.items()}
    for step in range(6):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
        if step == 2:
            g["params"]["conv0_a"]["bias"][1] = np.nan
        active = 0.0 if step == 4 else 2.0
        # The scan body, train_lib.py:371-388.
        jg = jax.tree.map(jnp.asarray, g)
        finite = jax_precision.all_finite(jg)
        updates, new = tx.update(jg, jo, jp)
        do = (active > 0) & finite
        updates = jax.tree.map(lambda u: jnp.where(do, u, 0.0), updates)
        jp = optax.apply_updates(jp, updates)
        jo = jax_precision.select_tree(do, new, jo)
        je = jax.tree.map(lambda e, q: d * e + (1.0 - d) * q, je, jp)

        flat = params_io._flatten(g)
        grads = [torch.from_numpy(flat[params_io.jax_name(n)]) for n in tp]
        finite_out = torch.tensor(False)
        opt.update(tp, grads, ts, te, torch.tensor(active), finite_out)
        assert bool(finite_out) == bool(finite)
        for n, t in tp.items():
            key = params_io.jax_name(n)
            np.testing.assert_allclose(
                t.numpy(), params_io._flatten(jax.tree.map(np.asarray, jp))
                [key], atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(
                te[n].numpy(), params_io._flatten(jax.tree.map(
                    np.asarray, je))[key], atol=1e-6, rtol=1e-6)
        want = [np.asarray(x) for x in jax.tree.leaves(jo)]
        got = opt.leaves(ts)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_optimizer_leaves_round_trip_both_ways():
    # JAX's leaves (dict keys sorted: conv10_a before conv1_a, bias before
    # kernel) load into the port's named state, each where JAX's tree path
    # says, and come back in the same order.
    jmodel = jax_convstack.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=11, features=2)
    params = jmodel.init_params(None)
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=11, features=2)
    names = dict(model.module.named_parameters())
    for name in optim_ops.OPTIMIZERS:
        cfg = dict(optimizer=name, learning_rate_decay_factor=0.5,
                   decay_steps=5)
        tx = jax_optimizer.optimizer_from_config(
            jax_optimizer.OptimizerConfig(**cfg))
        path_leaves, _ = jax.tree_util.tree_flatten_with_path(
            tx.init(params))
        rng = np.random.RandomState(1)
        marked = [rng.randn(*np.shape(x)).astype(np.float32) if np.ndim(x)
                  else np.asarray(7 + i, np.int32)
                  for i, (_, x) in enumerate(path_leaves)]
        opt = optimizer_lib.Optimizer(optimizer_lib.OptimizerConfig(**cfg))
        state = opt.init(names)
        opt.load_leaves(state, marked)
        for (path, _), want in zip(path_leaves, marked):
            keys = [getattr(k, "name", getattr(k, "key", None))
                    for k in path]
            group = keys[2]
            if group == "count":
                # The schedule's state sits at chain index 1 of the core.
                got = state["sched_count" if path[1].idx == 1 else "count"]
            else:
                layer, leaf = keys[4], keys[5]
                got = state[group][
                    f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"]
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} {keys}")
        for a, b in zip(opt.leaves(state), marked):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_refused_options_raise_not_implemented():
    model = convstack_3d.ConvStack3DFFNModel(**MODEL)
    # bf16 and f16 train (test_torch_train_lowp.py): the state carries the
    # JAX policy's loss scale (none for bf16, DynamicLossScale for f16).
    for name in ("bf16", "f16"):
        jcfg, cfg = configs(precision=name)
        state, _ = train_lib.create_train_state(model, cfg)
        want = jax_precision.loss_scale_for(jax_precision.get_policy(
            jcfg.precision))
        assert type(state.scale_state).__name__ == type(want).__name__
        assert [t.numpy() for t in state.scale_state.leaves()] == [
            np.asarray(x) for x in jax.tree.leaves(want)]
    _, cfg = configs(remat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_lib.create_train_state(model, cfg)
    # The data-dependent policies train on the host loop; the scan steps
    # refuse them with the JAX package's own error, as JAX's run_training
    # does.
    for policy in ("max_pred_moves", "no_step"):
        jcfg, cfg = configs(fov_policy=policy)
        _, opt = train_lib.create_train_state(model, cfg)
        for make in (train_lib.make_scan_train_step,
                     train_lib.make_scan_train_step_packed):
            with pytest.raises(NotImplementedError) as err:
                make(model, opt, cfg)
            with pytest.raises(NotImplementedError) as jax_err:
                jax_train_loop.run_training("convstack_3d.ConvStack3DFFNModel",
                                            "", jcfg, None, None)
            assert str(err.value) == str(jax_err.value)
        assert callable(train_lib.make_fov_train_step(model, opt,
                                                      config=cfg))
    _, cfg = configs()
    _, opt = train_lib.create_train_state(model, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_lib.make_scan_train_step_packed(model, opt, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_lib.make_fov_train_step(model, opt, mesh=object())
    with pytest.raises(ValueError):
        precision_lib.get_policy("f64")
