"""K10's chunk plan and index arithmetic on the CPU (ops/conv3d.py's
k10_geometry, mirrored from csrc/wgrad32.cuh's w10_plan): every position
lies in exactly one chunk and every chunk goes to one CTA, by the shape
alone; and a numpy model of the kernel's staging and reads (x's halo of
three planes of cy + 2 rows of cx + 2 voxels with pre_relu applied on it,
g masked by y at the chunk's positions v = ry (cx + 2) + rx, zero in the
padding columns, each tap one fixed offset, the thread groups' positions
and their sums in group order) matches `jax.vjp` of
`lax.conv_general_dilated` at Precision.HIGHEST within 1e-5 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu_torch.ops import conv3d

torch.set_num_threads(1)

SHAPES = [(33, 33, 33), (9, 10, 11), (3, 4, 200), (1, 1, 1), (2, 3, 700),
          (5, 1, 6)]
WIDTHS = list(conv3d.K10_SHAPES)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [1, 4])
def test_k10_chunks_cover_every_position_once(b, shape, widths, masked):
    geo = conv3d.k10_geometry(b, *shape, *widths, masked)
    assert geo is not None and geo.smem <= conv3d.K15_SMEM
    count = np.zeros((b,) + shape, np.int64)
    owner = {}
    for cta in range(geo.ctas):
        for c in geo.cta_chunks(cta):
            assert c not in owner
            owner[c] = cta
            n, z, y0, y1, x0, x1 = geo.chunk(c)
            count[n, z, y0:y1, x0:x1] += 1
    assert sorted(owner) == list(range(geo.chunks))
    assert (count == 1).all()
    assert geo.ctas == min(conv3d.K10_CTAS, geo.chunks)
    assert geo.groups * 27 * (widths[0] // geo.cb) * (widths[1] // 8) == \
        conv3d.K10_THREADS
    # The assignment is the shape's alone: a fresh plan is the same.
    conv3d.k10_geometry.cache_clear()
    assert conv3d.k10_geometry(b, *shape, *widths, masked) == geo


def test_k10_plan_at_the_training_shapes():
    # B = 4: 1452 chunks of 3 rows, 11 a CTA; B = 1: the host loop's 363.
    for b, chunks in ((4, 1452), (1, 363)):
        geo = conv3d.k10_geometry(b, 33, 33, 33, 32, 32, True)
        assert (geo.cy, geo.cx, geo.chunks, geo.ctas) == (3, 33, chunks, 132)
    # Rows too wide for a stage take columns; other widths, no plan.
    wide = conv3d.k10_geometry(1, 2, 3, 700, 32, 32, True)
    assert wide.cy == 1 and wide.cx < 700 and wide.nx > 1
    assert conv3d.k10_geometry(1, 9, 9, 9, 13, 40, True) is None
    assert conv3d.k10_geometry(1, 9, 9, 9, 8, 8, False) is None


def k10_model(x, dy, y, pre_relu, geo):
    """(dW (27, Cin, Cout), db) in float32 as the kernel sums them: per CTA
    its chunks in order; per chunk the staged halo (pre_relu applied to the
    copies) and g (masked, zero past the chunk's columns); each thread
    group's positions v = j, j + G, ... at the tap's fixed offset; the
    groups' sums added in group order, the CTAs' rows in row order."""
    bsz, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    cy, cx = geo.cy, geo.cx
    hx, hy = cx + 2, cy + 2
    g_all = dy if y is None else np.where(y > 0, dy, np.float32(0))
    xr = np.maximum(x, np.float32(0)) if pre_relu else x
    xp = np.pad(xr, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    offs = [((t // 9) * hy + t // 3 % 3) * hx + t % 3 for t in range(27)]
    rows = []
    for cta in range(geo.ctas):
        part = np.zeros((geo.groups, 27, cin, cout), np.float32)
        bias = np.float32(0) * np.zeros(cout, np.float32)
        for c in geo.cta_chunks(cta):
            n, z, y0, y1, x0, x1 = geo.chunk(c)
            halo = np.zeros((3, hy, hx, cin), np.float32)
            blk = xp[n, z:z + 3, y0:y1 + 2, x0:min(x0 + hx, w + 2)]
            halo[:, :blk.shape[1], :blk.shape[2]] = blk
            # the stage's flat halo, with two voxels of slack
            flat = np.concatenate([halo.reshape(-1, cin),
                                   np.zeros((2, cin), np.float32)])
            gs = np.zeros((y1 - y0, hx, cout), np.float32)
            gs[:, :x1 - x0] = g_all[n, z, y0:y1, x0:x1]
            gs = gs.reshape(-1, cout)
            nv = gs.shape[0]
            for j in range(geo.groups):
                v = np.arange(j, nv, geo.groups)
                for t in range(27):
                    part[j, t] += flat[v + offs[t]].T @ gs[v]
            bias = bias + gs.sum(axis=0)
        total = part[0].copy()
        for j in range(1, geo.groups):
            total += part[j]
        rows.append((total, bias))
    dw = rows[0][0].copy()
    db = rows[0][1].copy()
    for t, b in rows[1:]:
        dw += t
        db += b
    return dw.reshape(3, 3, 3, cin, cout), db


# (Cin, Cout, pre_relu, post_relu): conv0_a, a block's _a and _b, the CI
# checkpoint's 16-feature block_a.
CASES = {"conv0_a": (2, 32, False, True), "block_a": (32, 32, True, True),
         "block_b": (32, 32, False, False),
         "ci_block_a": (16, 16, True, True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", [(2, 7, 8, 9), (1, 3, 2, 40)])
def test_k10_model_matches_jax_vjp(case, shape):
    cin, cout, pre, post = CASES[case]
    rng = np.random.RandomState(cin + cout + pre + post + shape[-1])
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * 0.3).astype(np.float32)
    dy = rng.randn(*shape, cout).astype(np.float32)

    def f(w, b):
        h = jax.nn.relu(x) if pre else x
        out = jax.lax.conv_general_dilated(
            h, w, (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST) + b
        return jax.nn.relu(out) if post else out
    y, vjp = jax.vjp(f, jnp.asarray(w), jnp.zeros(cout, jnp.float32))
    dw_j, db_j = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    geo = conv3d.k10_geometry(*shape, cin, cout, post)
    dw, db = k10_model(x, dy, np.asarray(y) if post else None, pre, geo)
    for got, want in ((dw, dw_j), (db, db_j)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
