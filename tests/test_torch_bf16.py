"""bfloat16 inference in ffn_tpu_torch against the JAX package, and the
saved-segmentation format against the JAX package's.

The port's bfloat16 layers (K15's plain version on the CPU) against flax's
`nn.Conv(dtype=bfloat16)`, the bf16 model against JAX's, a bf16 request
through both Runners. Two float32 orders round a sum near a bfloat16
boundary to neighbouring values, and later roundings carry the step on, so
a layer is held to one bf16 ulp per rounding (k15_tolerance) and at most
BF16_DIFFER_SHARE of outputs differing; logits within 2^-7 of max|logit|
(CI checkpoint), 2^-6 (model-r2). Saved `request` and `counters` entries
are the JAX package's protos; `origins` from either package or google/ffn
load without importing them.
"""

import json
import os
import subprocess
import sys
import textwrap

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ffn_tpu.inference import runner as jax_runner
from ffn_tpu.inference import storage as jax_storage
from ffn_tpu.inference.counters import Counters
from ffn_tpu.models import convstack_3d as jax_convstack
from ffn_tpu.proto import inference_pb2
from ffn_tpu_torch.inference import runner
from ffn_tpu_torch.inference.settings import InferenceSettings
from ffn_tpu_torch.models import convstack_3d, params_io
from ffn_tpu_torch.ops import conv3d
from ffn_tpu_torch.ops.conv3d_bf16_check import K15_CASES, k15_tolerance
from test_torch_runner import PAD, SIZE, _request
from tools import synthetic_em  # noqa: E402 (test_torch_runner's path)

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHANTOM = os.path.join(REPO, "models", "phantom")
# Share of a layer's outputs that may differ from flax's (at most 3 of
# 46,656 measured, 6.4e-5; the sums' order decides which).
BF16_DIFFER_SHARE = 2e-4


def _flax_layer(case, x, w, b, r):
    """flax's bfloat16 Conv with the stack's arrangement of `case`."""
    k, _, cout, pre, post, rdt, _ = K15_CASES[case]
    conv = nn.Conv(cout, (k,) * 3, padding="SAME", dtype=jnp.bfloat16,
                   precision=lax.Precision.HIGHEST)
    net = jnp.asarray(x).astype(jnp.bfloat16)   # the stack's input cast
    if pre:
        net = nn.relu(net)
    y = conv.apply({"params": {"kernel": jnp.asarray(w),
                               "bias": jnp.asarray(b)}}, net)
    if post:
        y = nn.relu(y)
    if rdt == torch.bfloat16:
        y = y + jnp.asarray(r).astype(jnp.bfloat16)
    elif rdt == torch.float32:
        y = jnp.asarray(r) + y.astype(jnp.float32)   # seed + update
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("case", list(K15_CASES))
def test_plain_layer_matches_flax_bf16_conv(case):
    k, cin, cout, pre, post, rdt, xdt = K15_CASES[case]
    rng = np.random.RandomState(sorted(K15_CASES).index(case))
    x = rng.randn(2, 9, 9, 9, cin).astype(np.float32)
    w = (rng.randn(k, k, k, cin, cout)
         * (2.0 / (k ** 3 * cin)) ** 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    r = rng.randn(2, 9, 9, 9, cout).astype(np.float32) if rdt else None
    want = _flax_layer(case, x, w, b, r)

    # The layer before hands a bfloat16 tensor on; conv0_a takes float32.
    xt = torch.from_numpy(x).to(xdt)
    wt, bt = (torch.from_numpy(v).to(torch.bfloat16) for v in (w, b))
    rt = None if r is None else torch.from_numpy(r).to(rdt)
    kw = dict(pre_relu=pre, post_relu=post, residual=rt)
    got = conv3d.conv3d_ndhwc_bf16(xt, wt, bt, **kw)
    assert got.dtype == (torch.float32 if rdt == torch.float32
                         else torch.bfloat16)
    diff = np.abs(got.float().numpy() - want)
    tol = k15_tolerance(xt, wt, bt, **kw).numpy()
    assert (diff <= tol).all(), float((diff / tol).max())
    assert (diff > 0).mean() <= BF16_DIFFER_SHARE, (diff > 0).sum()


def _flax_tree(flat):
    tree = {"params": {}}
    for key, value in flat.items():
        _, layer, leaf = key.split("/")
        tree["params"].setdefault(layer, {})[leaf] = value
    return tree


@pytest.mark.parametrize("ckpt,fov,depth,features,n,tol", [
    ("model-ci-tiny.npz", 17, 2, 16, 2, 2.0 ** -7),
    ("model-r2.npz", 33, 12, 32, 1, 2.0 ** -6),
], ids=["ci", "r2"])
def test_bf16_model_matches_jax(ckpt, fov, depth, features, n, tol):
    flat = params_io.load_params_npz(os.path.join(PHANTOM, ckpt))
    kw = dict(fov_size=[fov] * 3, deltas=[8] * 3, depth=depth,
              features=features)
    rng = np.random.RandomState(6)
    image = rng.randn(n, fov, fov, fov, 1).astype(np.float32)
    seed = (rng.randn(n, fov, fov, fov, 1) * 2).astype(np.float32)
    jax_model = jax_convstack.ConvStack3DFFNModel(dtype=jnp.bfloat16, **kw)
    want = np.asarray(jax_model.apply(_flax_tree(flat), jnp.asarray(image),
                                      jnp.asarray(seed)))
    model = convstack_3d.ConvStack3DFFNModel(dtype="bfloat16", **kw)
    model.load_params(flat)
    got = model.apply(torch.from_numpy(image), torch.from_numpy(seed))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err
    # The update differs from the float32 model's: the stack did run in
    # bfloat16.
    f32 = convstack_3d.ConvStack3DFFNModel(**kw)
    f32.load_params(flat)
    assert not torch.equal(got, f32.apply(torch.from_numpy(image),
                                          torch.from_numpy(seed)))


def test_bf16_model_keeps_float32_parameters():
    flat = params_io.load_params_npz(os.path.join(PHANTOM,
                                                  "model-ci-tiny.npz"))
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[17] * 3, deltas=[6] * 3, depth=2, features=16,
        dtype=torch.bfloat16, precision="highest")
    model.load_params(flat)
    state = model.module.state_dict()
    assert sorted(state) == sorted(params_io.convert_params(flat))
    assert all(v.dtype == torch.float32 for v in state.values())
    layer = model.module.conv0_b
    assert torch.equal(layer.weight16, layer.weight.to(torch.bfloat16))
    # It trains (test_torch_precision.py): train_apply runs the same stack
    # under autograd, and float16 models build with float32 parameters too
    # (the port's Runner refuses them: test_torch_train_lowp.py).
    net = torch.randn(1, 17, 17, 17, 2, generator=torch.Generator()
                      .manual_seed(0))
    got = model.train_apply(net, net[..., 1:])
    assert got.requires_grad and torch.equal(
        got.detach(), model.apply(net[..., :1], net[..., 1:]))
    f16 = convstack_3d.ConvStack3DFFNModel(
        fov_size=[17] * 3, deltas=[6] * 3, depth=2, features=16,
        dtype="float16")
    f16.load_params(flat)
    assert f16.module.conv0_b.weight16.dtype == torch.float16
    assert all(v.dtype == torch.float32
               for v in f16.module.state_dict().values())


def _entries(out_dir):
    """The saved `request` and `counters` entries of seg-0_0_0.npz, parsed
    as the JAX package's protos."""
    path = jax_storage.segmentation_path(str(out_dir), (0, 0, 0))
    counters = Counters()
    with np.load(path) as data:
        request = inference_pb2.InferenceRequest.FromString(
            bytes(data["request"]))
        counters.loads(data["counters"])
    return request, {name: c.value for name, c in counters}


# The port's segmentation against the JAX package's on the 48^3 phantom of
# test_torch_runner.py with the CI checkpoint in bfloat16: object-level
# agreement and share of equal voxels, each held just under its value
# measured on the CPU (the same with 1, 3 and 8 threads): serial 1.0 and
# 0.95555; 8 lanes 0.85714 and 0.85586. Both packages' segmentations score
# ground-truth agreement 1.0 (in float32 they are identical): rounding
# flips from the sums' order move boundary voxels, and at 8 lanes split
# one object differently.
RUNNER_AGREEMENT = {1: (1.0, 0.955), 8: (0.857, 0.855)}


def check_bf16_runner(tmp_path, lanes):
    """A bfloat16 request (model_args dtype bfloat16) with
    `concurrent_requests` `lanes` through both packages' Runners; both save
    the same request and counter names, as protos."""
    box = (SIZE + 2 * PAD,) * 3
    request, gt = _request(tmp_path, tmp_path / "jax")
    args = json.loads(request.model_args)
    args["dtype"] = "bfloat16"
    request.model_args = json.dumps(args)
    request.concurrent_requests = lanes
    want = jax_runner.Runner()
    want.start(request)
    want.run((0, 0, 0), box, keep_probability_maps=False)

    request.segmentation_output_dir = str(tmp_path / "torch")
    got = runner.Runner(device="cpu")
    got.start(request)
    assert got.model.dtype == torch.bfloat16
    got.run((0, 0, 0), box, keep_probability_maps=False)

    segs = [jax_storage.load_segmentation(str(tmp_path / side), (0, 0, 0),
                                          split_cc=False)[0]
            for side in ("jax", "torch")]
    agree = synthetic_em.object_level_agreement(*segs, min_size=300)
    voxels = float((segs[0] == segs[1]).mean())
    want_agree, want_voxels = RUNNER_AGREEMENT[lanes]
    assert agree >= want_agree and voxels >= want_voxels, (agree, voxels)
    inner = (slice(PAD, -PAD),) * 3
    assert all(synthetic_em.object_level_agreement(
        gt.astype(np.uint64), seg[inner], min_size=300) == 1.0
        for seg in segs)

    (jax_req, jax_counts), (port_req, port_counts) = (
        _entries(tmp_path / side) for side in ("jax", "torch"))
    assert port_req.segmentation_output_dir == str(tmp_path / "torch")
    assert jax_req.segmentation_output_dir == str(tmp_path / "jax")
    port_req.segmentation_output_dir = jax_req.segmentation_output_dir
    assert port_req == jax_req
    assert sorted(port_counts) == sorted(jax_counts)
    assert port_counts["fov-moves" if lanes > 1 else "update_at-calls"] > 0


def test_bf16_lanes_runner_matches_jax_runner(tmp_path):
    """8 lanes with 16 hops (HopBatchCanvas); the serial request is
    test_torch_bf16_serial.py's, a file of its own so that parallel test
    workers, which take a file each, share the load."""
    check_bf16_runner(tmp_path, 8)


def test_settings_round_trip_through_the_proto(tmp_path):
    request, _ = _request(tmp_path, tmp_path / "out")
    settings = InferenceSettings.from_proto(request)
    # Unchanged settings give the proto's own bytes back.
    assert settings.to_proto(request).SerializeToString() == \
        request.SerializeToString()
    # Settings changed since (the sharded driver's seed handoff) are
    # written over it; settings built by hand make the same request.
    settings.seed_policy = "PolicyNeighborOriginsThenPeaks"
    settings.seed_policy_args = '{"corners": []}'
    proto = settings.to_proto(request)
    assert proto.seed_policy == "PolicyNeighborOriginsThenPeaks"
    assert InferenceSettings.from_proto(proto) == settings
    assert InferenceSettings.from_proto(settings.to_proto()) == settings
    assert not InferenceSettings(image="v.npy", model_name="m",
                                 segmentation_output_dir="o").to_proto(
    ).HasField("inference_options")


def _write_foreign_segmentations(root):
    """A segmentation saved by the JAX package, and one whose origins
    pickle OriginInfo under google/ffn's module, ffn.inference.storage
    (written in a child process that defines that module)."""
    labels = np.zeros((4, 5, 6), np.uint64)
    labels[1:3, 1:4, 2:5] = 7
    jax_storage.save_subvolume(
        labels, {7: jax_storage.OriginInfo((2, 2, 3), 11, 0.5)},
        jax_storage.segmentation_path(os.path.join(root, "jax"), (0, 0, 0)))
    code = textwrap.dedent(f"""
        import collections, os, sys, types
        import numpy as np
        for name in ("ffn", "ffn.inference", "ffn.inference.storage"):
            sys.modules[name] = types.ModuleType(name)
        OriginInfo = collections.namedtuple(
            "OriginInfo", ["start_zyx", "iters", "walltime_sec"])
        OriginInfo.__module__ = "ffn.inference.storage"
        sys.modules["ffn.inference.storage"].OriginInfo = OriginInfo
        labels = np.zeros((4, 5, 6), np.uint64)
        labels[1:3, 1:4, 2:5] = 7
        path = os.path.join({root!r}, "ffn", "0", "0", "seg-0_0_0.npz")
        os.makedirs(os.path.dirname(path))
        np.savez_compressed(path, segmentation=labels,
                            origins={{7: OriginInfo((2, 2, 3), 11, 0.5)}})
        """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_foreign_origins_load_without_their_packages(tmp_path):
    _write_foreign_segmentations(str(tmp_path))
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from ffn_tpu_torch.inference import storage
        for writer in ("jax", "ffn"):
            root = {str(tmp_path)!r} + "/" + writer
            origins = storage.load_origins(root, (0, 0, 0))
            seg, loaded = storage.load_segmentation(root, (0, 0, 0))
            for got in (origins, loaded):
                assert list(got) == [7] or list(got) == [1], got
                info = list(got.values())[0]
                assert type(info) is storage.OriginInfo, type(info)
                assert tuple(info) == ((2, 2, 3), 11, 0.5), info
            assert seg.dtype == np.uint64 and seg.max() == 1
        bad = sorted(m for m in sys.modules if m in ("jax", "ffn")
                     or m.split(".")[0] in ("ffn_tpu", "ffn"))
        assert not bad, bad
        """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
