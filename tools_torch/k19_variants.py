#!/usr/bin/env python3
"""Measures K19 (`qconv3d_s8`, csrc/qconv3d.cu) on the card: model-r2's int8
layer kinds (conv0_a 2->32 relu_out, block_a 32->32 relu_in and relu_out,
block_b 32->32 + residual, the 1^3 32->1 conv_lom) at N = 1, 4 and 64 on
33^3 lanes of magnitudes 1e-2 to 1e2, against `torch._int_mm` on the int8
im2col (the GEMM alone, 32->32 layers).

K19 is first held to its plain version bit for bit (and lane N // 2 alone
bit for bit as in the batch); then torch.profiler gives each call's device
time (the sum of its kernels) and CUDA events the time per call through the
wrapper, medians of samples taken in turns. Libraries built from the source
(variant_libs.py, one nvcc each, in parallel) with a part cut out, or in
another design, are timed beside it, each its C entry called on the same
inputs:
  --split: no MMAs (the sums zero), no input loads (zeros staged), no
    quantize (the float's bits staged), no epilogue stores;
  --options: (a) independent tiles: every item one plane, its three planes
    staged and quantized for it (K15's tiles, ~3-4 quantizations an
    element); (b) a quantize pre-pass: one kernel writes the lanes' int8
    inputs (294 MB read, 73 MB written at N = 64, 32 channels), then K19
    stages int8 words.
Their results are wrong where a part is cut; the options are held to plain
bit for bit too. Each result is one JSON line on stdout and in --out, with
the card's name and power limit.

  python tools_torch/k19_variants.py [--split] [--options] [--ptxas]
                                     [--ns 1,4,64] [--out FILE]

~1.5 min on an H100 with both options (~20 s of it the builds).
"""

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ffn_tpu_torch import _build  # noqa: E402
from ffn_tpu_torch.ops import quantized as q  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

SRC = os.path.join(variant_libs.CSRC, "qconv3d.cu")
ENTRY = "ffn_qconv3d_s8"

SPLIT = {
    "no MMAs": [("          pair_sums<CIN, COUT>(acc, sb, b_lane, m0, "
                 "lane, a.P, dz2, off2);",
                 "          for (int i = 0; i < 2 * G::NT * 4; ++i)\n"
                 "            (&acc[0][0][0])[i] = 0;")],
    "no input loads": [("    if (!live || u >= units) continue;",
                        "    if (live || u >= units) continue;")],
    "no quantize": [("    const uint32_t w = quantize4(v[j], scale, rcp, "
                     "relu);",
                     "    const uint32_t w = __float_as_uint(v[j].x);")],
    "no epilogue stores": [("                *reinterpret_cast<float2*>"
                            "(y + oc) = make_float2(v0, v1);",
                            "                if (v0 == 1234.5f) *reinterpret_"
                            "cast<float2*>(y + oc) = make_float2(v0, v1);")],
}

# (a) independent tiles: segments of one plane, three planes staged each.
OPT_TILES = [("    for (int nseg = 1; nseg <= D; ++nseg) {",
              "    for (int nseg = D; nseg <= D; ++nseg) {")]

# (c) the IEEE division for every element.
OPT_DIV = [("  const int q = d > __fmul_rn(fabsf(y), 0x1p-20f)",
            "  const int q = false && d > __fmul_rn(fabsf(y), 0x1p-20f)")]

# (d) plans of one CTA an SM allowed beside two (the bands that fill an
# SM's memory: the least cost of all bands).
OPT_ONE = [("    if (per_sm < min_per_sm) continue;",
            "    if (per_sm < 1) continue;")]

# (b) a quantize pre-pass into a scratch int8 copy of x (the variant's C
# entry allocates it once and grows it), then K19 stages int8 words: x is
# passed as the int8 tensor, its offsets in bytes.
PREPASS_CODE = r'''
__global__ void q_prepass_kernel(const float* __restrict__ x,
                                 const float* __restrict__ absmax, int relu,
                                 int8_t* __restrict__ xq, long long total,
                                 long long per_lane) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  const float scale = __fmul_rn(absmax[i / per_lane], kC127);
  if (i + 4 <= total && per_lane % 4 == 0) {
    *reinterpret_cast<uint32_t*>(xq + i) = quantize4(
        __ldg(reinterpret_cast<const float4*>(x + i)), scale,
        __frcp_rn(scale), relu);
    return;
  }
  for (long long j = i; j < i + 4 && j < total; ++j) {
    const float sj = __fmul_rn(absmax[j / per_lane], kC127);
    xq[j] = (int8_t)quantize(x[j], sj, __frcp_rn(sj), relu);
  }
}

int8_t* q_scratch = nullptr;
size_t q_scratch_bytes = 0;

}  // namespace
'''
OPT_PREPASS = [
    ("}  // namespace\n\n// x (N,D,H,W,Cin) float32; w: k = 3",
     PREPASS_CODE + "\n// x (N,D,H,W,Cin) float32; w: k = 3"),
    # offsets in bytes of the int8 copy
    ("    const float* xn = x + (size_t)n * a.D * hw * CIN;",
     "    const float* xn = reinterpret_cast<const float*>(\n"
     "        reinterpret_cast<const int8_t*>(x) + (size_t)n * a.D * hw * "
     "CIN);"),
    ("  const float* xp = xn + (size_t)(live ? zz : 0) * a.H * a.W * CIN;",
     "  const int8_t* xp = reinterpret_cast<const int8_t*>(xn) +\n"
     "                    (size_t)(live ? zz : 0) * a.H * a.W * CIN;"),
    ("    if constexpr (CIN == 2) {\n      const float2 f = __ldg(",
     "    if constexpr (true) {\n      uint32_t w = CIN == 2 ?\n"
     "          (uint32_t)*reinterpret_cast<const uint16_t*>(xp + (size_t)"
     "off * CIN) :\n          *reinterpret_cast<const uint32_t*>(xp + "
     "(size_t)off * CIN + c);\n      v[j].x = __uint_as_float(w);\n"
     "    } else if constexpr (CIN == 2) {\n      const float2 f = __ldg("),
    ("    const uint32_t w = quantize4(v[j], scale, rcp, relu);",
     "    const uint32_t w = __float_as_uint(v[j].x);"),
    ("  if ((long long)N * D * H * W == 0) return static_cast<int>("
     "cudaSuccess);",
     "  if ((long long)N * D * H * W == 0) return static_cast<int>("
     "cudaSuccess);\n"
     "  {\n"
     "    const long long total = (long long)N * D * H * W * Cin;\n"
     "    if ((size_t)total > q_scratch_bytes) {\n"
     "      if (q_scratch) cudaFree(q_scratch);\n"
     "      if (cudaMalloc(&q_scratch, total) != cudaSuccess) return 2;\n"
     "      q_scratch_bytes = total;\n"
     "    }\n"
     "    q_prepass_kernel<<<(unsigned)((total / 4 + 255) / 256 + 1), 256, 0,"
     " s>>>(\n"
     "        x, absmax, relu_in, q_scratch, total, (long long)D * H * W * "
     "Cin);\n"
     "    x = reinterpret_cast<const float*>(q_scratch);\n"
     "  }"),
]


def layer_inputs(rng, dev, n, k, cin, cout, res):
    """chip_smoke's int8 layer and lanes (magnitudes 1e-2 to 1e2, lane
    n // 2 zero), with its abs-maxima."""
    layer, x, r = cs._q_layer(rng, dev, n, k, cin, cout, res)
    return layer, x, r


def caller(fn, layer, x, am, r, ri, ro):
    n, d, h, w, cin = x.shape
    k, cout = layer.kernel_zyx[0], layer.w_q.shape[1]
    y = torch.empty((n, d, h, w, cout), device=x.device)
    wt = layer.w_k if k == 3 else layer.w_q
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), wt.data_ptr(), layer.w_scale.data_ptr(),
                 layer.bias.data_ptr(), am.data_ptr(),
                 r.data_ptr() if r is not None else None, y.data_ptr(), n,
                 d, h, w, cin, cout, k, int(ri), int(ro), stream)
        _build.check(err, "K19")
        return y
    return run


def im2col_mm(x, am, layer):
    """torch._int_mm on the int8 im2col of x (made outside the timing)."""
    xq = torch.nn.functional.pad(torch.clamp(torch.round(
        x / (am * q.C127).view(-1, 1, 1, 1, 1)), -127, 127).to(torch.int8),
        (0, 0, 1, 1, 1, 1, 1, 1))
    d = x.shape[1]
    cols = torch.cat([xq[:, t // 9:t // 9 + d, t // 3 % 3:t // 3 % 3 + d,
                         t % 3:t % 3 + d] for t in range(27)],
                     dim=-1).reshape(-1, 27 * x.shape[-1])
    return lambda: torch._int_mm(cols, layer.w_q)


def measure(emit, dev, ns, libs):
    rng = np.random.RandomState(17)
    for n in ns:
        for name, (k, cin, cout, ri, ro, res) in cs.Q_LAYERS.items():
            layer, x, r = layer_inputs(rng, dev, n, k, cin, cout, res)
            am = q.act_absmax(x, ri)
            kw = dict(relu_in=ri, relu_out=ro, residual=r)
            want = q.qconv3d_plain(x, layer, am, **kw)
            base = dict(kernel="K19", layer=name, n=n)
            if k == 3:
                geo = q.k19_geometry(n, 33, 33, 33, cin, cout)
                base.update(band_pos=geo.band_pos, seg=geo.seg,
                            items=geo.items, ctas=geo.ctas,
                            planes_per_output=geo.planes_per_output(),
                            quantized_per_element=geo.quantized_per_element())
            runs = {}
            for opt, lib in libs.items():
                if k != 3 and opt != "K19":
                    continue
                fn = getattr(lib, ENTRY)
                runs[opt] = caller(fn, layer, x, am, r, ri, ro)
                if opt not in SPLIT:
                    got = runs[opt]().clone()
                    i = n // 2
                    one = caller(fn, layer, x[i:i + 1].clone(), am[i:i + 1],
                                 None if r is None else r[i:i + 1].clone(),
                                 ri, ro)()
                    same = (torch.equal(got, want),
                            torch.equal(one[0], got[i]))
                    emit(dict(base, option=opt, equal_plain=same[0],
                              alone_equal=same[1]))
                    cs.require(all(same), f"K19 {opt} {name} N={n}")
            if k == 3 and cin == 32:
                runs["_int_mm (im2col GEMM)"] = im2col_mm(x, am, layer)
            for opt, fn in runs.items():
                t = variant_libs.device_split(fn)
                emit(dict(base, option=opt, host_us=t["host_us"],
                          device_us=sum(t["device_us"].values()),
                          device_by_kernel=t["device_us"]))
            lib = runs.get("_int_mm (im2col GEMM)")
            ms = cs.time_many(lambda: q.qconv3d(x, layer, am, **kw),
                              *([lib] if lib else []), reps=10)
            vox = n * 33 ** 3
            bound = cs.bound_of(4 * vox * (cin + cout * (2 if res else 1)),
                                2 * vox * k ** 3 * cin * cout,
                                peak=cs.INT8_OPS)
            emit(dict(base, option="per call: the wrapper, _int_mm",
                      ms=list(ms), bound_ms=bound[0], bound_by=bound[1]))
            del layer, x, r, want, runs, lib
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--options", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ns", default="1,4,64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    variants = {"K19": ([], [])}
    if args.split:
        variants.update({name: ([], cut) for name, cut in SPLIT.items()})
    if args.options:
        variants["(a) independent tiles"] = ([], OPT_TILES)
        variants["(b) quantize pre-pass"] = ([], OPT_PREPASS)
        variants["(c) IEEE division"] = ([], OPT_DIV)
        variants["(d) one CTA an SM allowed"] = ([], OPT_ONE)
    with variant_libs.emitter(args.out) as emit, \
            tempfile.TemporaryDirectory() as tmp:
        if args.ptxas:
            print("\n".join(variant_libs.ptxas_report([SRC], "qconv")))
        libs = variant_libs.build(tmp, SRC, variants, [ENTRY])
        emit(dict(kernel="K19", built=sorted(libs),
                  seconds=time.perf_counter() - t0))
        measure(emit, dev, [int(v) for v in args.ns.split(",")], libs)
        emit(dict(kernel="K19", seconds=time.perf_counter() - t0))


if __name__ == "__main__":
    main()
