"""ffn_tpu_torch's ResConvStack and its LayerNorm (K21's plain version)
against the JAX package's ffn_tpu.models.convstack_3d.ResConvStack and
flax's nn.LayerNorm, on the CPU at a small size (depth 3, 8 features, a
12^3 FOV, N = 2), with weights carried across by params_io.

XLA sums the channels in another order than the port's one fixed order,
so single LayerNorm layers are held within 2e-6 in float32 (unit-scale
inputs) and within one ulp of a 16-bit type (plus 2e-6 near 0); the
float32 stack within 1e-5 of max|logit|; the bfloat16 stack within 2^-6
of max|logit|, the form of test_torch_bf16.py (two orders round a sum
near a bfloat16 boundary to neighbouring values and later layers carry
the step on).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import params_io as jax_params_io
from ffn_tpu_torch.models import convstack_3d, params_io
from ffn_tpu_torch.ops import layernorm

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

DEPTH, FEATURES, FOV, N = 3, 8, 12, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# One ulp of each 16-bit type relative to the value (8 and 11 bits).
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
STACK_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _random_tree(use_layernorm, seed):
    """A JAX ResConvStack parameter tree with every leaf drawn anew:
    He-scaled kernels, biases ~0.1, LayerNorm scale 1 + 0.5 N(0, 1) and
    bias 0.3 N(0, 1)."""
    module = jax_convstack.ResConvStack(depth=DEPTH, features=FEATURES,
                                        use_layernorm=use_layernorm)
    init = module.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, FOV, FOV, FOV, 2), jnp.float32))
    rng = np.random.RandomState(seed)
    tree = {"params": {}}
    for layer, leaves in sorted(init["params"].items()):
        out = tree["params"][layer] = {}
        for leaf, value in sorted(leaves.items()):
            shape = np.shape(value)
            if leaf == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.randn(*shape) * (2.0 / fan_in) ** 0.5
            elif leaf == "scale":
                v = 1.0 + 0.5 * rng.randn(*shape)
            else:
                v = (0.3 if layer.startswith("ln") else 0.1) * rng.randn(
                    *shape)
            out[leaf] = v.astype(np.float32)
    return tree


def _inputs(seed=7):
    rng = np.random.RandomState(seed)
    return rng.randn(N, FOV, FOV, FOV, 2).astype(np.float32)


def _jax_logits(tree, x, use_layernorm, dtype):
    module = jax_convstack.ResConvStack(depth=DEPTH, features=FEATURES,
                                        use_layernorm=use_layernorm,
                                        dtype=DTYPES[dtype][0])
    return np.asarray(jax.jit(module.apply)(tree, jnp.asarray(x)))


def _port(tree, use_layernorm, dtype):
    model = convstack_3d.ResConvStack(depth=DEPTH, features=FEATURES,
                                      use_layernorm=use_layernorm,
                                      compute_dtype=dtype)
    model.load_params(tree)
    return model


@pytest.mark.parametrize("features", [8, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_plain_matches_flax(dtype, features):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(features)
    x = rng.randn(2, 8, 8, 8, features).astype(np.float32)
    scale = (1.0 + 0.5 * rng.randn(features)).astype(np.float32)
    bias = (0.3 * rng.randn(features)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax.jit(nn.LayerNorm(dtype=jdt).apply)(
        {"params": {"scale": scale, "bias": bias}}, xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = layernorm.layernorm_channels(xt, torch.from_numpy(scale),
                                       torch.from_numpy(bias))
    assert got.dtype == tdt and got.shape == xt.shape
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert float(diff.max()) <= 2e-6, float(diff.max())
    else:
        # The float32 results may fall on either side of a rounding
        # boundary (one ulp), or near 0 differ by the float32 tolerance.
        bound = ULP[dtype] * np.abs(want) + 2e-6
        assert (diff <= bound).all(), float((diff / bound).max())


def test_layernorm_plain_takes_flax_formula():
    # The fast variance clamps at 0: a constant voxel normalises to its
    # bias (x - mean = 0), as flax's layer gives it.
    x = torch.full((3, 32), 2.5)
    bias = torch.arange(32, dtype=torch.float32)
    got = layernorm.layernorm_channels(x, torch.full((32,), 3.0), bias)
    assert torch.equal(got, bias.expand(3, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_layernorm", [True, False],
                         ids=["layernorm", "no_layernorm"])
def test_resconvstack_matches_jax(use_layernorm, dtype):
    tree = _random_tree(use_layernorm, seed=3)
    x = _inputs()
    want = _jax_logits(tree, x, use_layernorm, dtype)
    model = _port(tree, use_layernorm, dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape == (N, FOV, FOV, FOV, 1)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= STACK_TOL[dtype] * float(np.abs(want).max()), err
    if use_layernorm:
        # The LayerNorms do act: without them the logits differ.
        bare = convstack_3d.ResConvStack(depth=DEPTH, features=FEATURES,
                                         use_layernorm=False,
                                         compute_dtype=dtype)
        bare.load_params({"params": {k: v for k, v in tree["params"].items()
                                     if not k.startswith("ln")}})
        with torch.no_grad():
            assert float((bare(torch.from_numpy(x)) - got).abs().max()) \
                > 100 * err


def test_params_round_trip(tmp_path):
    tree = _random_tree(True, seed=5)
    model = _port(tree, True, "float32")
    assert sorted(model.state_dict()) == sorted(
        params_io.convert_params(tree))
    assert "ln1.scale" in model.state_dict()
    path = str(tmp_path / "resconv.npz")
    params_io.save_params_npz(model, path)
    with np.load(path) as data:
        names = sorted(data.files)
    assert names == sorted(f"params/{layer}/{leaf}"
                           for layer, leaves in tree["params"].items()
                           for leaf in leaves)
    # JAX's leaf order of the tree, which optimizer files follow.
    paths = ["/".join(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [params_io.jax_name(n) for n in params_io.jax_leaf_order(
        model.state_dict())] == paths
    # The JAX package reads the file back as the tree it came from, and
    # flax applies it as it does the original.
    back = jax_params_io.load_params_npz(path)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert pa == pb and np.array_equal(a, b), pa
    x = _inputs(seed=8)
    np.testing.assert_array_equal(_jax_logits(back, x, True, "float32"),
                                  _jax_logits(tree, x, True, "float32"))


def test_grad_enabled_forward_raises():
    model = convstack_3d.ResConvStack(depth=2, features=4)
    x = torch.zeros(1, 5, 5, 5, 2)
    with pytest.raises(NotImplementedError):
        model(x)
    with torch.no_grad():
        assert model(x).shape == (1, 5, 5, 5, 1)
