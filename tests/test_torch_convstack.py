"""ffn_tpu_torch's ConvStack3D and K1's plain version against the JAX
package on the CPU, from numpy inputs: 1e-5 on small random stacks
(another float32 order), 2e-4 on the 12-layer fib25 golden (the bound of
test_reference_contracts.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu_torch.models import convstack_3d, params_io
from ffn_tpu_torch.ops import conv3d

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHANTOM = os.path.join(REPO, "models", "phantom")


def _run_both(jax_model, params, port_model, shape_zyx, seed=0):
    rng = np.random.RandomState(seed)
    image = rng.randn(1, *shape_zyx, 1).astype(np.float32)
    seed_logits = (rng.randn(1, *shape_zyx, 1) * 2).astype(np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(image),
                                      jnp.asarray(seed_logits)))
    port_model.load_params(params)
    got = port_model.apply(torch.from_numpy(image),
                           torch.from_numpy(seed_logits)).numpy()
    return got, want


def test_random_params_match_jax():
    kw = dict(fov_size=[9, 9, 9], deltas=[2, 2, 2], depth=2, features=8)
    jax_model = jax_convstack.ConvStack3DFFNModel(**kw)
    params = jax_model.init_params(jax.random.PRNGKey(7))
    # Scale the 0.01-std init so the update is not lost under the seed.
    params = jax.tree.map(lambda p: p * 20.0, params)
    got, want = _run_both(jax_model, params,
                          convstack_3d.ConvStack3DFFNModel(**kw), (9, 9, 9))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ckpt,fov,deltas", [
    ("model-ci-tiny.npz", [17, 17, 17], [6, 6, 6]),
    ("model-ci-tiny-b.npz", [17, 17, 9], [6, 6, 3]),
], ids=["tiny", "tiny-b"])
def test_shipped_tiny_checkpoints_match_jax(ckpt, fov, deltas):
    flat = params_io.load_params_npz(os.path.join(PHANTOM, ckpt))
    kw = dict(fov_size=fov, deltas=deltas, depth=2, features=16)
    tree = {"params": {}}
    for key, value in flat.items():
        _, layer, leaf = key.split("/")
        tree["params"].setdefault(layer, {})[leaf] = value
    got, want = _run_both(jax_convstack.ConvStack3DFFNModel(**kw), tree,
                          convstack_3d.ConvStack3DFFNModel(**kw),
                          tuple(fov[::-1]), seed=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fib25_golden_logits():
    fx = np.load(os.path.join(REPO, "tests", "golden",
                              "fib25_logits_golden.npz"))
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33, 33, 33], deltas=[8, 8, 8], depth=12, features=32)
    model.load_params(params_io.load_params_npz(
        os.path.join(REPO, "models", "fib25", "model-27465036.npz")))
    out = model.apply(torch.from_numpy(fx["image"]),
                      torch.from_numpy(fx["seed_logits"])).numpy()
    assert out.shape == fx["logits"].shape
    np.testing.assert_allclose(out, fx["logits"], atol=2e-4)


def test_convert_params_names_and_layout():
    flat = params_io.load_params_npz(os.path.join(PHANTOM,
                                                  "model-ci-tiny.npz"))
    state = params_io.convert_params(flat)
    assert set(state) == set(convstack_3d.ConvStack3D(
        depth=2, features=16).state_dict())
    np.testing.assert_array_equal(state["conv0_a.weight"].numpy(),
                                  flat["params/conv0_a/kernel"])


# Every flag combination the stack uses, at the stack's channel shapes
# (narrowed): conv0_a, conv0_b, a block's _a and _b, and conv_lom.
K1_CASES = {
    "conv0_a": (3, 2, 8, False, True, False),
    "conv0_b": (3, 8, 8, False, False, False),
    "block_a": (3, 8, 8, True, True, False),
    "block_b": (3, 8, 8, False, False, True),
    "conv_lom": (1, 8, 1, True, False, True),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_matches_lax_conv(case):
    k, cin, cout, pre, post, res = K1_CASES[case]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 6, 5, cin).astype(np.float32)
    w = (rng.randn(k, k, k, cin, cout) * 0.2).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    r = rng.randn(2, 7, 6, 5, cout).astype(np.float32) if res else None

    xin = np.maximum(x, 0) if pre else x
    want = lax.conv_general_dilated(
        jnp.asarray(xin), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST) + b
    want = np.asarray(want)
    if post:
        want = np.maximum(want, 0)
    if res:
        want = want + r

    got = conv3d.conv3d_ndhwc_f32(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        pre_relu=pre, post_relu=post,
        residual=torch.from_numpy(r) if res else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
