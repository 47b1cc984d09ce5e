"""ffn_tpu_torch's FloodFillEngine.step (K2, model, K3) against the JAX one:
the same steps from the same numpy inputs, the patch and the whole seed
compared after each; the oracle bit for bit; the CI checkpoint within 1e-5
(logits off in the last digits) with the NaN pattern exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ffn_tpu.inference import engine as jax_engine
from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import engine
from ffn_tpu_torch.models import convstack_3d, oracle, params_io
from ffn_tpu_torch.ops import step as step_ops

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "models", "phantom", "model-ci-tiny.npz")
FOV = 9
PAD = float(np.log(0.05 / 0.95))
MOVE_T = float(np.log(0.9 / 0.1))
SHAPE = (20, 22, 24)
# Steps around the volume, overlapping each other, revisiting, and two near
# faces where dynamic_slice moves the start (pos - FOV//2 < 0 wraps, then
# clamps; pos + FOV//2 >= shape clamps).
POSITIONS = [(10, 11, 12), (12, 11, 12), (12, 13, 10), (10, 11, 12),
             (2, 3, 21), (18, 20, 1), (8, 9, 14)]


def _engines(kind, disco):
    kw = dict(fov_size=[FOV] * 3, deltas=[2, 2, 2])
    thresholds = dict(pad_value=PAD, move_threshold=MOVE_T,
                      disco_seed_threshold=disco)
    if kind == "oracle":
        jmodel, params = jax_oracle.ThresholdOracleModel(**kw), {}
        pmodel = oracle.ThresholdOracleModel(**kw)
    else:  # the shipped tiny CI checkpoint: 17^3 FOV, depth 2, 16 features
        kw = dict(fov_size=[17] * 3, deltas=[6] * 3, depth=2, features=16)
        flat = params_io.load_params_npz(TINY)
        params = {"params": {}}
        for key, value in flat.items():
            _, layer, leaf = key.split("/")
            params["params"].setdefault(layer, {})[leaf] = value
        jmodel = jax_convstack.ConvStack3DFFNModel(**kw)
        pmodel = convstack_3d.ConvStack3DFFNModel(**kw)
        pmodel.load_params(flat)
    return (jax_engine.FloodFillEngine(jmodel, params, **thresholds),
            engine.FloodFillEngine(pmodel, device="cpu", **thresholds))


@pytest.mark.parametrize("disco", [-1.0, 0.0, 0.5])
@pytest.mark.parametrize("kind", ["oracle", "convstack"])
def test_step_matches_jax_engine(kind, disco):
    jeng, peng = _engines(kind, disco)
    rng = np.random.RandomState(11)
    image = rng.randn(*SHAPE).astype(np.float32)

    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jseed = jeng.reset_seed(jeng.new_seed_buffer(SHAPE), POSITIONS[0], 3.0)
    pseed = peng.reset_seed(peng.new_seed_buffer(SHAPE), POSITIONS[0], 3.0)
    exact = kind == "oracle"
    for pos in POSITIONS:
        jseed, jpatch = jeng.step(jimg, jseed, pos)
        pseed, ppatch = peng.step(pimg, pseed, pos)
        want, got = np.asarray(jseed), pseed.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        if exact:
            np.testing.assert_array_equal(ppatch, jpatch)
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(ppatch, jpatch, atol=1e-5)
            np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.isnan(want).any() and not np.isnan(want).all()


class _FixedLogits:
    """A JAX-side model whose update is the logits it is given as params,
    so the JAX engine's own crop/disco/select (engine.py:88-119) runs on
    exactly the logits the port's step_update gets."""

    def __init__(self):
        from ffn_tpu.models import model_info
        self.info = model_info.ModelInfo(deltas=[2] * 3,
                                         pred_mask_size=[FOV] * 3,
                                         input_seed_size=[FOV] * 3,
                                         input_image_size=[FOV] * 3)

    def apply(self, params, image, seed):
        del image, seed
        return params[None, ..., None]


@pytest.mark.parametrize("disco", [-1.0, 0.0, 0.5])
def test_step_update_disco_mask(disco):
    # A seed with NaN, negative and positive voxels, and logits that raise
    # some negative ones: the keep-old mask decides where frac allows it.
    rng = np.random.RandomState(2)
    seed = rng.randn(12, 12, 12).astype(np.float32) * 3
    seed[rng.rand(*seed.shape) < 0.3] = np.nan
    logits = (rng.randn(FOV, FOV, FOV) * 3).astype(np.float32)
    pos = (6, 5, 7)
    start = [p - FOV // 2 for p in pos]
    sel = tuple(slice(s, s + FOV) for s in start)
    jeng = jax_engine.FloodFillEngine(
        _FixedLogits(), jax.numpy.asarray(logits), pad_value=PAD,
        move_threshold=MOVE_T, disco_seed_threshold=disco)
    want = np.asarray(jeng._apply_model(
        jax.numpy.zeros((FOV,) * 3), jax.numpy.asarray(seed[sel]),
        jax.numpy.asarray(jeng._opts_host)))

    tseed = torch.from_numpy(seed.copy())
    patch = step_ops.step_update(torch.from_numpy(logits), tseed, pos,
                                 (FOV,) * 3, MOVE_T, disco).numpy()
    np.testing.assert_array_equal(patch, want)
    expect = seed.copy()
    expect[sel] = want
    np.testing.assert_array_equal(tseed.numpy(), expect)
    if disco == 0.0:  # the mask is on and keeps some old values
        assert (patch != logits).any()


def test_step_gather_clamps_and_pads():
    # pos - size//2 = (-2, 8, 3) for the image: like lax.dynamic_slice, a
    # negative start wraps once (-2 + 10 = 8) and then clamps (to 10 - 5).
    rng = np.random.RandomState(4)
    image = rng.randn(10, 11, 12).astype(np.float32)
    seed = rng.randn(10, 11, 12).astype(np.float32)
    seed[::2] = np.nan
    img_p, seed_in = step_ops.step_gather(
        torch.from_numpy(image), torch.from_numpy(seed), (0, 10, 5),
        (5, 5, 5), (3, 3, 3), PAD)
    np.testing.assert_array_equal(img_p.numpy(), image[5:10, 6:11, 3:8])
    want = seed[7:10, 8:11, 4:7]
    want = np.where(np.isnan(want), np.float32(PAD), want)
    np.testing.assert_array_equal(seed_in.numpy(), want)


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.FloodFillEngine(
            oracle.ThresholdOracleModel(fov_size=[FOV] * 3, deltas=[2] * 3),
            pad_value=PAD, move_threshold=MOVE_T, disco_seed_threshold=0.0,
            device="cuda")
