"""K19's plan and index arithmetic on the CPU (ops/quantized.py's
k19_geometry, mirrored from csrc/qconv3d.cu's q_plan): the work items cover
every output voxel of every lane once; a CTA's shared memory fits; the
share of planes and elements staged; and a numpy model of the kernel's
staging and reads (the ring of quantized planes, the row pitch and halo
table, the fixed tap offsets, the swizzled 32-channel rows, the Cin = 16
half-warp taps and the Cin = 2 packing of two taps a word, the reciprocal
quantize) equals the JAX package's qconv3d, jitted under jax.vmap, bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

from ffn_tpu.ops import quantized as jax_quantized
from ffn_tpu_torch.ops import quantized

torch.set_num_threads(1)

WIDTHS = list(quantized.QCONV_SHAPES)
# 33^3 (the FOV), odd volumes, rows wider than a band, one voxel.
SHAPES = [(33, 33, 33), (5, 7, 9), (3, 5, 200), (1, 1, 1), (4, 1, 6)]


def _coverage(geo, n):
    count = np.zeros((n, geo.d, geo.h, geo.w), np.int64)
    for i in range(geo.items):
        lane, zs, ys, xs = geo.voxels(i)
        np.add.at(count, (lane, zs, ys, xs), 1)
    return count


# (lanes, shape, widths): N = 1 and 3 at every shape and width; 64 lanes at
# the FOV for every width and at the other shapes for 32->32.
COVER = ([(n, s, wd) for n in (1, 3) for s in SHAPES for wd in WIDTHS]
         + [(64, SHAPES[0], wd) for wd in WIDTHS]
         + [(64, s, (32, 32)) for s in SHAPES[1:]])


@pytest.mark.parametrize("n,shape,widths", COVER)
def test_k19_items_cover_every_voxel_once(n, shape, widths):
    geo = quantized.k19_geometry(n, *shape, *widths)
    assert (_coverage(geo, n) == 1).all()
    # Bands of whole pairs of m16 tiles; the halo rows reach one row and
    # one voxel beyond the band on both sides; the grid never exceeds the
    # items, and a CTA never holds two lanes in one item.
    assert geo.band_pos % quantized.K19_PAIR == 0
    assert geo.halo_rows == geo.band_pos + 2 * geo.pitch + 2
    assert geo.pitch % 2 == 0 and geo.pitch >= geo.w + 1
    assert geo.ctas == 132 * geo.per_sm
    assert geo.items == n * geo.bands * geo.nseg


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("n", [1, 3, 64])
def test_k19_plan_fits_and_reports_its_staging(n, widths):
    geo = quantized.k19_geometry(n, 33, 33, 33, *widths)
    assert geo.smem == quantized.k19_smem(geo.halo_rows, *widths)
    assert geo.per_sm * (geo.smem + 1024) <= quantized.K19_SMEM_SM
    # Two CTAs share an SM at every width of the stack (one CTA of the
    # wider bands lost 1.5x on the card).
    assert geo.per_sm == 2
    ppo, qpe = geo.planes_per_output(), geo.quantized_per_element()
    assert ppo == (geo.d + 2 * geo.nseg) / geo.d
    assert 1.0 <= qpe <= 3 * geo.halo_rows / geo.band_pos + 1e-9
    if n == 64 and widths[0] == 32:
        # The inner layers at 64 lanes: each input element quantized about
        # once (a 4x4x8 box quantizing its own halo: 4.06 times).
        assert qpe <= 1.3 and ppo <= 1.3


def test_k19_plan_takes_n_and_the_card_as_given():
    a = quantized.k19_geometry(64, 33, 33, 33, 32, 32)
    b = quantized.k19_geometry(64, 33, 33, 33, 32, 32, sms=66)
    assert a.ctas == 264 and b.ctas == 132
    assert quantized.k19_geometry(1, 33, 33, 33, 32, 32).items >= 132
    with pytest.raises(ValueError, match="do not fit"):
        quantized.k19_geometry(1, 3, 3, 20000, 32, 32)


def test_kernel_layout_pads_and_transposes_w_q():
    rng = np.random.RandomState(5)
    for cin, cout in WIDTHS:
        layer = quantized.fold_convstack_params({"c": {
            "kernel": rng.randn(3, 3, 3, cin, cout).astype(np.float32),
            "bias": np.zeros(cout, np.float32)}})["c"]
        k = 27 * cin
        kpad = -(-k // 32) * 32
        w_k = layer.w_k.numpy()
        assert w_k.shape == (cout, kpad + 16) and w_k.dtype == np.int8
        np.testing.assert_array_equal(w_k[:, :k], layer.w_q.numpy().T)
        assert not w_k[:, k:].any()
        assert quantized.QuantizedConv(layer.w_q, layer.w_scale, layer.bias,
                                       (1, 1, 1)).w_k is None


# -- a numpy model of the kernel --------------------------------------------

def _f32(v):
    return np.float32(v)


def quantize_model(v, scale, relu):
    """qconv3d.cu's quantize: y = v * rcp (rcp the float32 reciprocal),
    rint(y) where y lies more than |y| 2^-20 from the nearest half-integer,
    else rint of the IEEE quotient; clipped to +-127."""
    v = np.asarray(v, np.float32)
    if relu:
        v = np.where(v < 0, np.float32(0), v)
    scale = _f32(scale)
    rcp = _f32(1) / scale
    with np.errstate(invalid="ignore", over="ignore"):
        y = (v * rcp).astype(np.float32)
        d = np.abs(y - (np.floor(y) + _f32(0.5))).astype(np.float32)
        fast = d > (np.abs(y) * _f32(2.0 ** -20)).astype(np.float32)
        q = np.where(fast, np.rint(y), np.rint(v / scale))
    return np.clip(q, -127, 127).astype(np.int8)


def _ring_byte(h, c, cin):
    if cin == 32:
        return h * 32 + ((((c >> 4) ^ (h >> 2)) & 1) << 4) + (c & 15)
    return h * cin + c


def k19_model(x, w_k, absmax, relu_in, geo):
    """int32 sums (N, D, H, W, Cout) of the kernel's walk: per item, each
    plane z0 - 1 .. z1 quantized into a ring slot through the halo table;
    each output plane z read from the slots of z - 1, z, z + 1 at the tap
    offsets dy P + dx, in the kernel's k order, against the packed
    weights."""
    n, d, h, w, cin = x.shape
    cout = w_k.shape[0]
    kpad = w_k.shape[1] - 16
    P, M, R = geo.pitch, geo.band_pos, geo.halo_rows
    acc = np.zeros((n, d, h, w, cout), np.int64)
    m = np.arange(M)
    for i in range(geo.items):
        lane, q0, z0, z1 = geo.item(i)
        scale = _f32(absmax[lane]) * _f32(quantized.C127)
        tab = geo.halo_voxels(q0)
        ring = {}
        for zz in range(z0 - 1, z1 + 1):
            slot = np.zeros(R * cin, np.int8)
            if 0 <= zz < d:
                rows = np.nonzero(tab >= 0)[0]
                vals = quantize_model(
                    x[lane, zz].reshape(h * w, cin)[tab[rows]], scale,
                    relu_in)
                for c in range(cin):
                    slot[_ring_byte(rows, c, cin)] = vals[:, c]
            ring[zz] = slot

        def row_bytes(zz, r, c0, nbytes):
            # bytes c0 .. c0 + nbytes - 1 of ring rows r (a 16-byte
            # ldmatrix row, or a 16-bit load at Cin 2)
            return np.stack([ring[zz][_ring_byte(r, c0 + j, cin)]
                             for j in range(nbytes)], axis=-1)

        def tap_rows(t):
            t = min(t, 26)   # taps past 26 read tap 26: zero weights
            return t // 9, (t // 3 % 3) * P + t % 3
        for z in range(z0, z1):
            a = np.zeros((M, kpad), np.int64)   # A: rows x k, as read
            for s in range(kpad // 32):
                if cin == 32:    # one tap a step, two 16-byte halves
                    dz, off = tap_rows(s)
                    for kh in range(2):
                        a[:, 32 * s + 16 * kh:32 * s + 16 * kh + 16] = \
                            row_bytes(z - 1 + dz, m + off, 16 * kh, 16)
                elif cin == 16:  # lanes 0-15 tap 2s, lanes 16-31 tap 2s+1
                    for half in range(2):
                        dz, off = tap_rows(2 * s + half)
                        a[:, 32 * s + 16 * half:32 * s + 16 * half + 16] = \
                            row_bytes(z - 1 + dz, m + off, 0, 16)
                else:            # Cin 2: words of two taps' 16-bit pairs
                    for kh in range(2):
                        for t in range(4):
                            for e in range(2):
                                dz, off = tap_rows(16 * s + 8 * kh + 2 * t
                                                   + e)
                                k0 = 32 * s + 16 * kh + 4 * t + 2 * e
                                a[:, k0:k0 + 2] = row_bytes(z - 1 + dz,
                                                            m + off, 0, 2)
            sums = a @ w_k[:, :kpad].astype(np.int64).T   # (M, Cout)
            q = q0 + m
            ys, xs = q // P, q % P
            keep = (ys < h) & (xs < w)
            acc[lane, z, ys[keep], xs[keep]] = sums[keep]
    return acc


def _jax_qconv(layer, relu_in):
    def one(x):
        if relu_in:
            x = jax.nn.relu(x)
        return jax_quantized.qconv3d(x[None], layer)[0]
    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("relu_in", [False, True])
def test_k19_model_matches_jax_bit_for_bit(widths, relu_in):
    cin, cout = widths
    rng = np.random.RandomState(cin + cout + relu_in)
    params = {"c": {
        "kernel": (rng.randn(3, 3, 3, cin, cout) * 0.05).astype(np.float32),
        "bias": rng.randn(cout).astype(np.float32)}}
    tl = quantized.fold_convstack_params(params)["c"]
    jl = jax_quantized.fold_convstack_params(params)["c"]
    shape = (4, 5, 6, 7)
    mags = (10.0 ** np.array([-2, 0, 2, 1]))[:, None, None, None, None]
    x = (rng.randn(*shape, cin) * mags).astype(np.float32)
    x[2] = 0   # a zero lane: its abs-max floored at 1e-12
    absmax = quantized.act_absmax_plain(torch.from_numpy(x), relu_in)
    geo = quantized.k19_geometry(*shape, cin, cout)
    acc = k19_model(x, tl.w_k.numpy(), absmax.numpy(), relu_in, geo)
    scale, s = quantized.lane_scales(tl, absmax)
    got = quantized.fma_f32(torch.from_numpy(acc.astype(np.float32)),
                            s.reshape(-1, 1, 1, 1, cout), tl.bias).numpy()
    want = np.asarray(_jax_qconv(jl, relu_in)(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_reciprocal_quantize_equals_the_division():
    """On values at, beside and between the half-integer boundaries of
    several scales (the cases the reciprocal's product may round across),
    and random ones, quantize_model equals rint of the IEEE quotient."""
    rng = np.random.RandomState(7)
    for m in [1e-12, 3e-7, 0.1, 1.0, 7.3, 1e2, 3.3e5]:
        scale = _f32(m) * _f32(quantized.C127)
        k = np.arange(-128, 128, dtype=np.float32) + _f32(0.5)
        edge = (k * scale).astype(np.float32)
        vals, up, down = [edge], edge, edge
        for _ in range(3):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            vals += [up, down]
        vals.append((rng.randn(20000) * m).astype(np.float32))
        vals.append((rng.rand(20000).astype(np.float32) * _f32(m)))
        v = np.concatenate(vals).astype(np.float32)
        want = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
        for relu in (False, True):
            w = np.where(v < 0, 0, want) if relu else want
            np.testing.assert_array_equal(quantize_model(v, scale, relu), w)
