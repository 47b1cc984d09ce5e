"""ffn_tpu_torch's round-based batched step (K13, model, K14) against the JAX
FloodFillEngine's select_step, step_batch and lane resets, on the same
crafted numpy states (NaN seeds and candidates, `ignore`, weak starts,
inactive lanes, faces where starts wrap then clamp, out-of-volume
candidates, the disco mask on and off). With the rule-based oracle and an
"identity" model (crafted ties and NaN logits) everything matches bit for
bit; with the CI checkpoint (logits differ in the last digits) the
integer fields are equal, scores and seeds within 1e-5 of max|logit|, the
NaN pattern exact, and K14's plain version fed JAX's own logits bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.inference import engine as jax_engine
from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.models import model_info as jax_model_info
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import engine
from ffn_tpu_torch.models import convstack_3d, model_info, oracle, params_io
from ffn_tpu_torch.ops import select as select_ops
from test_torch_engine import MOVE_T, PAD, SHAPE, TINY

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

B, K = 9, 3


class _JaxIdentity:
    """JAX-side model whose update is its image patch (seed 9, pred 7)."""

    def __init__(self, deltas):
        self.info = jax_model_info.ModelInfo(
            deltas=deltas, pred_mask_size=[7] * 3, input_seed_size=[9] * 3,
            input_image_size=[9] * 3)

    def apply(self, params, image, seed):
        del params, seed
        return image


class _Identity:
    def __init__(self, deltas):
        self.info = model_info.ModelInfo(
            deltas=deltas, pred_mask_size=[7] * 3, input_seed_size=[9] * 3,
            input_image_size=[9] * 3)

    def apply(self, image, seed):
        del seed
        return image.clone()


def _engines(kind, disco):
    thresholds = dict(pad_value=PAD, move_threshold=MOVE_T,
                      disco_seed_threshold=disco)
    if kind == "oracle":
        kw = dict(fov_size=[9] * 3, deltas=[2, 2, 2])
        jmodel, params = jax_oracle.ThresholdOracleModel(**kw), {}
        pmodel = oracle.ThresholdOracleModel(**kw)
    elif kind == "identity":
        deltas = [3, 0, 2]   # xyz: the y axis does not move
        jmodel, params, pmodel = _JaxIdentity(deltas), {}, _Identity(deltas)
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


def crafted_image(rng, kind):
    image = rng.randn(*SHAPE).astype(np.float32)
    if kind == "identity":
        # Logits on a coarse grid tie face maxima; a few are NaN.
        image = np.round(image * 4) / 2 + 1.5
        image[rng.rand(*SHAPE) < 0.01] = np.nan
    return image.astype(np.float32)


def crafted_seeds(rng):
    seeds = (rng.randn(B, *SHAPE) * 3).astype(np.float32)
    seeds[rng.rand(B, *SHAPE) < 0.3] = np.nan
    return seeds


def crafted_round(rng, seeds):
    """(candidates (B,K,3), start (B,3), active, ignore) with every case."""
    dims = np.array(SHAPE)
    cands = rng.randint(0, dims, size=(B, K, 3)).astype(np.int32)
    start = rng.randint(0, dims, size=(B, 3)).astype(np.int32)
    strong = np.float32(MOVE_T + 1)
    for b in range(B):
        seeds[(b,) + tuple(start[b])] = strong      # a start that holds
    weak_start = 1
    seeds[(weak_start,) + tuple(start[weak_start])] = np.float32(MOVE_T - 1)
    nan_start = 2
    seeds[(nan_start,) + tuple(start[nan_start])] = np.nan
    # Lane 3: NaN, then below, then valid; lane 4: none valid.
    seeds[(3,) + tuple(cands[3, 0])] = np.nan
    seeds[(3,) + tuple(cands[3, 1])] = np.float32(MOVE_T - 0.5)
    seeds[(3,) + tuple(cands[3, 2])] = strong
    for k in range(K):
        seeds[(4,) + tuple(cands[4, k])] = np.nan if k % 2 else np.float32(
            MOVE_T - 2)
    # Faces: lanes 5-8 sit at every face's corner, one out of the volume.
    cands[5, 0] = (0, 0, 0)
    cands[6, 0] = dims - 1
    cands[7, 0] = (1, dims[1] - 2, 3)
    cands[8, 0] = (-2, dims[1] + 3, dims[2] - 1)
    for b in (5, 6, 7, 8):
        idx = np.clip(np.where(cands[b, 0] < 0, cands[b, 0] + dims,
                               cands[b, 0]), 0, dims - 1)
        seeds[(b,) + tuple(idx)] = strong
    active = np.ones(B, bool)
    active[6] = False
    ignore = np.zeros(B, bool)
    ignore[[0, 4]] = True   # lane 4: NaN/below candidates, taken anyway
    return cands, start, active, ignore


def _tol(kind, want):
    if kind == "convstack":
        return 1e-5 * float(np.nanmax(np.abs(want[np.isfinite(want)])))
    return 0.0


def assert_packed_equal(got, want, kind):
    for name in ("executed", "chosen", "start_ok", "offsets", "pos"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
    w = np.asarray(want["scores"])
    np.testing.assert_array_equal(np.isinf(got["scores"]), np.isinf(w))
    np.testing.assert_allclose(got["scores"], w, rtol=0, atol=_tol(kind, w))


def assert_seeds_equal(got, want, kind):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(kind, want))


@pytest.mark.parametrize("kind,disco", [
    ("oracle", -1.0), ("oracle", 0.0), ("identity", -1.0),
    ("identity", 0.3), ("convstack", -1.0), ("convstack", 0.0)])
def test_select_step_matches_jax(kind, disco):
    jeng, peng = _engines(kind, disco)
    rng = np.random.RandomState(5)
    image = crafted_image(rng, kind)
    seeds = crafted_seeds(rng)
    jimg, pimg = jeng.put_image(image), peng.put_image(image)
    jseeds = jnp.asarray(seeds)
    pseeds = torch.from_numpy(seeds.copy())
    executed = 0
    for _ in range(3):   # the seeds evolve from round to round
        host = np.asarray(jseeds).copy()
        args = crafted_round(rng, host)
        jseeds = jnp.asarray(host)
        pseeds.copy_(torch.from_numpy(host))
        jseeds, want = jeng.select_step(jimg, jseeds, *args)
        pseeds, got = peng.select_step(pimg, pseeds, *args)
        assert_packed_equal(got, want, kind)
        assert_seeds_equal(pseeds.numpy(), np.asarray(jseeds), kind)
        executed += int(got["executed"].sum())
        assert not got["executed"][[1, 2, 6]].any()   # weak, NaN, inactive
        assert got["chosen"][3] == 2 and got["chosen"][4] == 0
        assert np.isinf(got["scores"][~got["executed"]]).all()
    assert executed >= 12


def test_select_update_plain_is_bit_exact_on_jax_logits():
    jeng, peng = _engines("convstack", 0.0)
    rng = np.random.RandomState(6)
    image = crafted_image(rng, "convstack")
    seeds = crafted_seeds(rng)
    args = crafted_round(rng, seeds)
    jseeds, want = jeng.select_step(jeng.put_image(image),
                                    jnp.asarray(seeds), *args)
    packed_in = np.concatenate([
        args[0].reshape(B, -1), args[1], args[2][:, None].astype(np.int32),
        args[3][:, None].astype(np.int32)], axis=1)
    pseeds = torch.from_numpy(seeds.copy())
    img, seed_in, rec = select_ops.select_gather_plain(
        torch.from_numpy(image), pseeds, torch.from_numpy(packed_in),
        image_size=peng._image_size, seed_size=peng._seed_size,
        move_threshold=MOVE_T, pad=PAD)
    logits = np.array(jeng.model.apply(
        jeng.params, jnp.asarray(img.numpy()[..., None]),
        jnp.asarray(seed_in.numpy()[..., None])))[..., 0]
    packed, _ = select_ops.select_update_plain(
        torch.from_numpy(logits), pseeds, rec, pred_size=peng._pred_size,
        deltas=[6, 6, 6], move_threshold=MOVE_T, disco_threshold=0.0)
    want_packed = np.concatenate([
        np.asarray(want["executed"], np.float32)[:, None],
        np.asarray(want["chosen"], np.float32)[:, None],
        np.asarray(want["start_ok"], np.float32)[:, None],
        np.asarray(want["scores"]),
        np.asarray(want["offsets"]).reshape(B, 18).astype(np.float32),
        np.asarray(want["pos"], np.float32)], axis=1)
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    np.testing.assert_array_equal(pseeds.numpy(), np.asarray(jseeds))


@pytest.mark.parametrize("kind,disco", [
    ("oracle", 0.0), ("identity", 0.3), ("convstack", -1.0)])
def test_step_batch_matches_jax(kind, disco):
    jeng, peng = _engines(kind, disco)
    rng = np.random.RandomState(7)
    image = crafted_image(rng, kind)
    seeds = crafted_seeds(rng)
    cands, _, active, _ = crafted_round(rng, seeds)
    pos = cands[:, 0]
    jseeds, want = jeng.step_batch(jeng.put_image(image), jnp.asarray(seeds),
                                   pos, active)
    pseeds, got = peng.step_batch(peng.put_image(image),
                                  torch.from_numpy(seeds.copy()), pos, active)
    assert got.shape == (B,) + tuple(peng._pred_size)
    assert_seeds_equal(got, np.asarray(want), kind)
    assert_seeds_equal(pseeds.numpy(), np.asarray(jseeds), kind)
    # The inactive lane's seeds are untouched, its logits still returned.
    np.testing.assert_array_equal(pseeds.numpy()[6], seeds[6])


def test_lane_resets_match_jax():
    jeng, peng = _engines("oracle", 0.0)
    rng = np.random.RandomState(8)
    np.testing.assert_array_equal(
        peng.new_seed_batch(3, SHAPE).numpy(),
        np.asarray(jeng.new_seed_batch(3, SHAPE)))
    seeds = crafted_seeds(rng)
    mask = np.zeros(B, bool)
    mask[[0, 4, 7]] = True
    pos = rng.randint(0, SHAPE, size=(B, 3)).astype(np.int32)
    want = np.asarray(jeng.reset_lanes(jnp.asarray(seeds), mask, pos, 2.5))
    got = peng.reset_lanes(torch.from_numpy(seeds.copy()), mask, pos, 2.5)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jeng.reset_seed_lane(jnp.asarray(seeds), 5, pos[5],
                                           3.0))
    got = peng.reset_seed_lane(torch.from_numpy(seeds.copy()), 5, pos[5], 3.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[5]).sum() == want[5].size - 1
    unchanged = peng.reset_lanes(torch.from_numpy(seeds.copy()),
                                 np.zeros(B, bool), pos, 2.5)
    np.testing.assert_array_equal(unchanged.numpy(), seeds)


def test_select_kernels_reject_bad_inputs():
    seeds = torch.zeros((2,) + SHAPE)
    image = torch.zeros(SHAPE)
    kw = dict(image_size=(9,) * 3, seed_size=(9,) * 3, move_threshold=MOVE_T,
              pad=PAD)
    with pytest.raises(ValueError):   # (B, 3K+5) with K = 0
        select_ops.select_gather(image, seeds,
                                 torch.zeros((2, 5), dtype=torch.int32), **kw)
    with pytest.raises(TypeError):
        select_ops.select_gather(image, seeds, torch.zeros((2, 8)), **kw)
    with pytest.raises(ValueError):
        select_ops.select_update(torch.zeros(3, 9, 9, 9), seeds,
                                 torch.zeros((2, 6), dtype=torch.int32),
                                 pred_size=(9,) * 3, deltas=(2,) * 3,
                                 move_threshold=MOVE_T, disco_threshold=0.0)
