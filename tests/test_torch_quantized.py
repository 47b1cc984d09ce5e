"""ffn_tpu_torch's int8 inference (ops/quantized.py: K19's and K20's plain
versions) against the JAX package's ffn_tpu.ops.quantized, bit for bit:
the folded weights, one layer and the whole stack, each as the engines run
it (jitted under jax.vmap, the layers closed over as constants, so XLA's CPU
program folds `/ 127` into a product and dequantizes with one FMA), and the
serial and hops-0 Runners (FFN_TPU_PRECISION=int8 and precision="int8")
on test_torch_runner.py's phantom with the CI checkpoint. The hop and
fused paths: test_torch_quantized_paths.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.ops import quantized as jax_quantized
from ffn_tpu_torch.inference import runner
from ffn_tpu_torch.models import convstack_3d, params_io
from ffn_tpu_torch.ops import quantized
from test_torch_runner import CKPT, PAD, _request

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

SIZE = 32   # the phantom's edge; padded by PAD to 48^3

# name -> (k, Cin, Cout, relu_in, relu_out, residual): the stack's layer
# kinds (conv0_a, a block's conv_a and conv_b, conv_lom) at Cin 2, 8, 32.
LAYERS = {
    "cin2_relu_out": (3, 2, 8, False, True, False),
    "cin8_relu_in_out": (3, 8, 8, True, True, False),
    "cin32_residual": (3, 32, 32, False, False, True),
    "k1_relu_in_residual": (1, 32, 1, True, False, True),
}


def _random_layer(rng, k, cin, cout):
    kernel = (rng.randn(k, k, k, cin, cout) * 0.05).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return {"kernel": kernel, "bias": bias}


def _jax_layer(layer, relu_in, relu_out, residual):
    """One layer as the engines run it: jitted, vmapped over lanes."""
    def one(x, r):
        if relu_in:
            x = jax.nn.relu(x)
        y = jax_quantized.qconv3d(x[None], layer)[0]
        if relu_out:
            y = jax.nn.relu(y)
        return y + r if residual else y
    return jax.jit(jax.vmap(one))


def _port_layer(x, layer, relu_in, relu_out, r):
    return quantized.qconv3d(x, layer, quantized.act_absmax(x, relu_in),
                             relu_in=relu_in, relu_out=relu_out,
                             residual=r).numpy()


def _fold_both(params):
    return (jax_quantized.fold_convstack_params(params),
            quantized.fold_convstack_params(params))


def _tree(flat):
    tree = {}
    for path, value in flat.items():
        _, layer, leaf = path.split("/")
        tree.setdefault(layer, {})[leaf] = value
    return tree


def test_fold_matches_jax_on_the_ci_checkpoint_and_random_layers():
    flat = params_io.load_params_npz(CKPT)
    tree = dict(_tree(flat))
    rng = np.random.RandomState(0)
    for k, cin, cout, *_ in LAYERS.values():
        tree[f"random_{k}_{cin}_{cout}"] = _random_layer(rng, k, cin, cout)
    tree["zero"] = {"kernel": np.zeros((3, 3, 3, 2, 8), np.float32),
                    "bias": np.zeros(8, np.float32)}
    want, got = _fold_both({"params": tree})
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.kernel_zyx == w.kernel_zyx and g.w_q.dtype == torch.int8
        np.testing.assert_array_equal(g.w_q.numpy(), np.asarray(w.w_q))
        for a, b in ((g.w_scale, w.w_scale), (g.bias, w.bias)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    # The Runner's path: the port's model folds its own loaded parameters.
    port, _, qparams = _models(17, 2, 16, flat)
    for name, w in qparams.items():
        np.testing.assert_array_equal(port.layers[name].w_q.numpy(),
                                      np.asarray(w.w_q))


@pytest.mark.parametrize("case", list(LAYERS))
def test_one_layer_matches_jax_bit_for_bit(case):
    """Three lanes of magnitudes 1, 1e3 and 1e-3 (inputs with negatives),
    each quantized with its own scale; a lane's result is the same alone."""
    k, cin, cout, relu_in, relu_out, res = LAYERS[case]
    rng = np.random.RandomState(1)
    params = {"params": {"c": _random_layer(rng, k, cin, cout)}}
    jl, tl = (f["c"] for f in _fold_both(params))
    mags = np.array([1.0, 1e3, 1e-3], np.float32)[:, None, None, None, None]
    x = (rng.randn(3, 9, 9, 9, cin) * mags).astype(np.float32)
    r = rng.randn(3, 9, 9, 9, cout).astype(np.float32)
    want = np.asarray(_jax_layer(jl, relu_in, relu_out, res)(x, r))
    xt, rt = torch.from_numpy(x), torch.from_numpy(r) if res else None
    got = _port_layer(xt, tl, relu_in, relu_out, rt)
    np.testing.assert_array_equal(got, want)
    alone = _port_layer(xt[1:2], tl, relu_in, relu_out,
                        rt[1:2] if res else None)
    np.testing.assert_array_equal(alone[0], got[1])


def test_round_half_to_even_and_the_zero_lane_match_jax():
    """Lane 0 lies on (k + 1/2) * scale exactly (scale a power of two, so
    x / scale is exact): every quantization is a tie, rounded to even.
    Lane 1 is all zero: its scale is 1e-12's."""
    rng = np.random.RandomState(2)
    params = {"params": {"c": _random_layer(rng, 3, 8, 8)}}
    jl, tl = (f["c"] for f in _fold_both(params))
    scale = np.float32(2.0 ** -3)
    m = np.float32(127 * scale)
    while np.float32(m * np.float32(quantized.C127)) != scale:
        m = np.nextafter(m, np.float32(np.inf))
    ks = rng.randint(-126, 126, (9, 9, 9, 8))
    lane0 = ((ks + 0.5) * scale).astype(np.float32)
    lane0[0, 0, 0, 0] = m   # the lane's abs-max
    assert np.all((lane0 / scale)[1:] % 1 == 0.5)
    x = np.stack([lane0, np.zeros_like(lane0)])
    want = np.asarray(_jax_layer(jl, False, False, False)(x, x))
    got = _port_layer(torch.from_numpy(x), tl, False, False, None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        quantized.act_absmax(torch.from_numpy(x)).numpy(),
        np.array([m, np.float32(1e-12)], np.float32))


def test_fma_rounds_once_where_float64_lands_on_a_float32_tie():
    """a * s + b whose float64 sum rounds onto a float32 midpoint: rounding
    that again (ties to even) goes the wrong way; one FMA rounding, as
    XLA's and K19's, goes to the side of the exact sum."""
    a = torch.tensor([2 ** 23 + 1, -(2 ** 23 + 1), 2 ** 23 - 1],
                     dtype=torch.float32)
    s = torch.tensor([2 ** -7 * (1 - 2 ** -23)] * 2
                     + [2 ** -7 * (1 + 2 ** -23)])
    b = torch.tensor([2.0 ** 40 + 2 ** 17, -2.0 ** 40 - 2 ** 17, 2.0 ** 40])
    # Exact: 2^40 + 3 * 2^16 - 2^-30 (and its negation): just under the
    # midpoint, so the lower neighbour 2^40 + 2^17; the third is no tie.
    want = [2.0 ** 40 + 2 ** 17, -2.0 ** 40 - 2 ** 17, float(np.float32(
        2.0 ** 40 + (2 ** 23 - 1) * 2 ** -7 * (1 + 2 ** -23)))]
    assert quantized.fma_f32(a, s, b).tolist() == want
    assert (a.double() * s.double() + b.double()).float().tolist() != want


def _models(fov, depth, features, flat):
    base = convstack_3d.ConvStack3DFFNModel(
        fov_size=[fov] * 3, deltas=[2] * 3, depth=depth, features=features)
    base.load_params(flat)
    port = quantized.QuantizedConvStack3DModel(base)
    port.prepare()
    jmodel = jax_quantized.QuantizedConvStack3DModel(
        jax_convstack.ConvStack3DFFNModel(fov_size=[fov] * 3, deltas=[2] * 3,
                                          depth=depth, features=features))
    return port, jmodel, jmodel.prepare({"params": _tree(flat)})


@pytest.mark.parametrize("seed_dtype", ["float32", "bfloat16"])
def test_stack_matches_jax_bit_for_bit(seed_dtype):
    """The CI checkpoint's geometry on 3 lanes, as the engines apply it;
    bfloat16 seeds reach both models as bf16 and are widened inside."""
    port, jmodel, qparams = _models(17, 2, 16,
                                    params_io.load_params_npz(CKPT))
    rng = np.random.RandomState(3)
    image = rng.randn(3, 17, 17, 17, 1).astype(np.float32)
    seed = np.where(rng.rand(3, 17, 17, 17, 1) < 0.5, -2.9444,
                    rng.randn(3, 17, 17, 17, 1) * 3).astype(np.float32)
    seed[2] *= 100
    jseed = jnp.asarray(seed, jnp.dtype(seed_dtype))
    want = np.asarray(jax.jit(jax.vmap(
        lambda i, s: jmodel.apply(qparams, i[None], s[None])[0]))(
            image, jseed))
    tseed = torch.from_numpy(np.array(jseed.astype(jnp.float32))).to(
        getattr(torch, seed_dtype))
    got = port.apply(torch.from_numpy(image), tseed)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port.apply(torch.from_numpy(image[2:]), tseed[2:]).numpy(), want[2:])


def _counts(counters):
    return {name: c.value for name, c in counters if not name.endswith("-ms")}


def _runs(tmp_path, lanes, canvas_defaults, start):
    """(segmentation, origins, counters) of the JAX and the port's Runner on
    the padded 32^3 phantom with the CI checkpoint."""
    box = (SIZE + 2 * PAD,) * 3
    request, _ = _request(tmp_path, tmp_path / "jax", size=SIZE)
    request.concurrent_requests = lanes
    out = []
    for side, r in (("jax", jax_runner.Runner()),
                    ("torch", runner.Runner(device="cpu"))):
        request.segmentation_output_dir = str(tmp_path / side)
        r.canvas_defaults.update(canvas_defaults)
        start(r, request)
        cv = r.run((0, 0, 0), box, keep_probability_maps=False)
        out.append((cv.segmentation, {k: (tuple(v.start_zyx), v.iters)
                                      for k, v in cv.origins.items()},
                    _counts(r.counters), r))
    return out


def _assert_same(runs):
    (wseg, worigins, wcounts, want), (seg, origins, counts, got) = runs
    assert isinstance(got.model, quantized.QuantizedConvStack3DModel)
    assert isinstance(want.model, jax_quantized.QuantizedConvStack3DModel)
    np.testing.assert_array_equal(seg, wseg)
    assert origins == worigins and len(origins) >= 2
    assert counts == wcounts and counts


def test_serial_runner_through_the_environment_matches_jax(tmp_path,
                                                           monkeypatch):
    """FFN_TPU_PRECISION=int8 with precision=None, in both Runners; then the
    port's serial CLI with the same variable gives the same segmentation."""
    monkeypatch.setenv("FFN_TPU_PRECISION", "int8")
    runs = _runs(tmp_path, 1, {}, lambda r, request: r.start(request))
    _assert_same(runs)
    from ffn_tpu_torch.cli import run_inference
    request = runs[1][3]._request_proto
    request.segmentation_output_dir = str(tmp_path / "cli")
    box = SIZE + 2 * PAD
    run_inference.main([
        f"--inference_request={request}",
        f"--bounding_box=start {{ x:0 y:0 z:0 }} size {{ x:{box} y:{box} "
        f"z:{box} }}", "--device=cpu"])
    seg, origins = jax_storage.load_segmentation(str(tmp_path / "cli"),
                                                 (0, 0, 0), split_cc=False)
    wseg, worigins = jax_storage.load_segmentation(str(tmp_path / "jax"),
                                                   (0, 0, 0), split_cc=False)
    np.testing.assert_array_equal(seg, wseg)
    assert {k: v.iters for k, v in origins.items()} == \
        {k: v.iters for k, v in worigins.items()}


def test_round_based_runner_matches_jax(tmp_path):
    """hops 0 (BatchCanvas, select_step) at 4 lanes, precision="int8"."""
    _assert_same(_runs(tmp_path, 4, {"hops": 0},
                       lambda r, request: r.start(request, precision="int8")))


def test_other_precisions_run_the_model_as_it_is(tmp_path):
    """The JAX Runner acts on "int8" only; so does the port's."""
    request, _ = _request(tmp_path, tmp_path / "out", size=SIZE)
    r = runner.Runner(device="cpu")
    r.start(request, precision="bf16")
    assert isinstance(r.model, convstack_3d.ConvStack3DFFNModel)


def test_int8_raises_for_cuda_tensors_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    request, _ = _request(tmp_path, tmp_path / "out", size=SIZE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner(device="cuda").start(request, precision="int8")


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.RandomState(4)
    layer = quantized.fold_convstack_params(
        {"params": {"c": _random_layer(rng, 3, 8, 8)}})["c"]
    x = torch.zeros(2, 5, 5, 5, 8)
    am = quantized.act_absmax(x)
    with pytest.raises(ValueError, match="one abs-max per lane"):
        quantized.qconv3d(x, layer, am[:1])
    with pytest.raises(ValueError, match="does not match w_q"):
        quantized.qconv3d(torch.zeros(2, 5, 5, 5, 4), layer, am)
    with pytest.raises(TypeError):
        quantized.qconv3d(x.double(), layer, am)
    with pytest.raises(TypeError):
        quantized.act_absmax(x.double())
    with pytest.raises(ValueError, match="residual"):
        quantized.qconv3d(x, layer, am, residual=torch.zeros(2, 5, 5, 5, 1))
