#!/usr/bin/env python3
"""Device times of the small-M q4b product body's design variants
(csrc/qmm_txn.cuh under qmm_txn and qmm_txn_g), of the body it replaced,
and of its yardsticks, side by side on one card.

    python3 scripts/probe_txn.py [--parent DIR] [--check] [--only V,...] [--sass DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Each variant's two C entries (csrc/qmm_txn.cu, qmm_txn_g.cu) are
built with nvcc, all at once, under llamafile_tpu_torch/build/probe_txn/
<variant>/, and ptxas's register and spill notes are printed (--sass DIR:
also cuobjdump -sass of each variant's qmm_txn). Every variant but the
diagnostic ones is then checked within 1e-5 of the plain version
(qmm_txn_plain, qmm_txn_g_plain) at every shape, and its bit-for-bit
agreement with `kernel` reported; then all are timed as chip_smoke.py times
a kernel (a run of launches cycling over enough layers of a stack to spill
the L2, captured into a CUDA graph, the median of 25 replays), after one
discarded warm-up reading, in the order below and then in reverse, beside
torch.matmul on the weights dequantized to bf16 beforehand (torch.bmm on
each tile's expert for qmm_txn_g). The shapes are chip_smoke.py phase 2's:
qmm_txn at llama3-8b's products for M = 32, 16 and 8 rows and the lm head
at 8, and qmm_txn_g's gate|up and down at Mixtral-8x7B's widths for 16
routed slots (tm 8) and 512 (tm 32). --check builds and checks only;
--only times the named variants (and `kernel`).

Variants:
  kernel     csrc/qmm_txn.cuh as the port builds it (a 4-stage cp.async
             ring of weight chunks, scales, bias rows, activation codes and
             scales, one block barrier a chunk, the bias sums a chunk ahead;
             s8 mma.sync m16n8k32 in the swap-AB form, NT = ceil(M / 8) n8
             row tiles; 4 warps, each on its own 32 columns; the K split of
             ops.qmatmul.n_split, 3 blocks an SM)
  split2     the kernel with K split for 2 blocks an SM
  split4     the same for 4 blocks an SM
  ring3      a 3-stage ring
  ring5      a 5-stage ring
  lb1        no minimum of blocks an SM in __launch_bounds__ (ptxas's own
             register budget)
  comb4      the split-K combine's loads 4 splits at a time (the kernel: 2)
  shared_comb the split-K combine of qmm_common.cuh (one float a thread
             and split at a time) in place of the kernel's float4 one
  magic      the mma accumulator seeded with the bits of 1.5 * 2**23 so the
             int32 dot reads as a float and one exact fma replaces the
             int-to-float conversion and the scale multiply (same bits)
  regpf      the weights straight from device memory into registers, one
             chunk ahead, as qmm_int8.cu loads them (the ring carries the
             scales, bias and activations only)
  dp4a       the ring with the parent's int8 math: __dp4a on the CUDA cores
             after a 4x4 byte transpose, each lane on 4 columns and every
             fourth row (separates the pipeline from the tensor cores), at
             ptxas's own register budget (under the kernel's it spills)
  loads_only diagnostic: the kernel's copies, barriers and combine, no math
  math_only  diagnostic: the math on the prologue's stages, no later copies
  loads_w    diagnostic: the weight copies alone (no scales, bias,
             activations, math)
  parent     with --parent DIR: the body of an unpacked checkout
             (DIR/llamafile_tpu_torch/csrc/), built with its own headers, at
             the same K split

The last line printed is one JSON object of every reading.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_build  # noqa: E402

# dp4a: each lane holds the 32 k of its 4 strip columns (8 transposes of
# the swizzled rows) and runs rows q, q + 4, ... of the tile
DP4A_MATH = r'''// dp4a: lane (g, q) of warp w holds strip columns 4g..4g+3 and tile rows
// q + 4i; acc[4i + cc] is row q + 4i, column 4g + cc.
template <int NT>
__device__ __forceinline__ void txn_math(const unsigned char* p, bool has_bias, float* acc) {
  using St = TxnStage<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int byte = 32 * warp + 4 * g;
  int lo[32], hi[32];
#pragma unroll
  for (int tt = 0; tt < 8; ++tt) {
    uint32_t w[4], cw[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int R = 4 * tt + r;
      w[r] = *reinterpret_cast<const uint32_t*>(
          p + St::W + R * TN + 16 * txn_swz(R, byte >> 4) + (byte & 15));
    }
    transpose4x4(w, cw);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      lo[4 * tt + cc] = lo_plane(cw[cc]);
      hi[4 * tt + cc] = hi_plane(cw[cc]);
    }
  }
  const __nv_bfloat16* scs = reinterpret_cast<const __nv_bfloat16*>(p + St::SC);
  const __nv_bfloat16* bis = reinterpret_cast<const __nv_bfloat16*>(p + St::BI);
  float scl[4], sch[4], bl4[4], bh4[4];
  load_bf16x4(scs + byte, scl);
  load_bf16x4(scs + TN + byte, sch);
  if (has_bias) {
    load_bf16x4(bis + byte, bl4);
    load_bf16x4(bis + TN + byte, bh4);
  }
  const float* sxs = reinterpret_cast<const float*>(p + St::SX);
  const float* bss = reinterpret_cast<const float*>(p + St::BS);
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    const int m = q + 4 * i;
    const int* xw = reinterpret_cast<const int*>(p + St::X + m * St::XROW);
    int dlo[4] = {0, 0, 0, 0}, dhi[4] = {0, 0, 0, 0};
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) {
      const int xl = xw[tt], xh = xw[8 + tt];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        dlo[cc] = __dp4a(lo[4 * tt + cc], xl, dlo[cc]);
        dhi[cc] = __dp4a(hi[4 * tt + cc], xh, dhi[cc]);
      }
    }
    const float sxl = sxs[m], sxh = sxs[St::MP + m];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      acc[4 * i + cc] += ((float)dlo[cc] * scl[cc]) * sxl;
      acc[4 * i + cc] += ((float)dhi[cc] * sch[cc]) * sxh;
    }
    if (has_bias) {
      const float bl = bss[m], bh = bss[St::MP + m];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[4 * i + cc] += bl * bl4[cc] + bh * bh4[cc];
    }
  }
}

template <int NT>
__device__ __forceinline__ void txn_store(const float* acc, float* vals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      vals[(q + 4 * i) * TN + 32 * warp + 4 * g + cc] = acc[4 * i + cc];
}

'''

# regpf: this lane's eight weight words of chunk c from device memory
REGPF_LOAD = r'''// regpf: this lane's weight words of chunk c, rows 4q + r and 16 + 4q + r.
__device__ __forceinline__ void txn_wload(const TxnArgs& a, int c, uint32_t* w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = a.n_base + 32 * warp + 4 * (lane >> 2);
  const bool ok = col < a.Ns;
  const uint8_t* p = a.qs + (size_t)(128 * (c >> 2) + 32 * (c & 3) + 4 * (lane & 3)) * a.Ns + col;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)r * a.Ns)) : 0u;
    w[4 + r] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)(16 + r) * a.Ns)) : 0u;
  }
}

template <int NT>
__global__'''

# magic: the mma's accumulator starts at the bits of 1.5 * 2**23, so its
# int32 result read as a float is 1.5 * 2**23 + d (|d| < 2**22), and
# fma(that, sc, -1.5 * 2**23 * sc) = d * sc rounded once: the product that
# the kernel's int-to-float conversion (a quarter-rate instruction) and
# multiply give, so the same bits
MAGIC_FOLD = r'''
        int d[4] = {0x4B400000, 0x4B400000, 0x4B400000, 0x4B400000};
        mma::mma_16832_s8(d, af[t], b0, b1);
        float* c = acc + (t * NT + u) * 4;
        c[0] += __fmaf_rn(__int_as_float(d[0]), scv[2 * t], nm[2 * t]) * s.x;
        c[1] += __fmaf_rn(__int_as_float(d[1]), scv[2 * t], nm[2 * t]) * s.y;
        c[2] += __fmaf_rn(__int_as_float(d[2]), scv[2 * t + 1], nm[2 * t + 1]) * s.x;
        c[3] += __fmaf_rn(__int_as_float(d[3]), scv[2 * t + 1], nm[2 * t + 1]) * s.y;
      }
'''
MAGIC = [
    ("    uint32_t af[2][4];",
     "    float nm[4];\n#pragma unroll\n"
     "    for (int cc = 0; cc < 4; ++cc) nm[cc] = -12582912.f * scv[cc];\n"
     "    uint32_t af[2][4];"),
    ("        int d[4] = {0, 0, 0, 0};", "      if (has_bias) {", MAGIC_FOLD)]
MATH_CALL = "    txn_math<NT>(stage(c), has_bias, acc);\n"
LOADS_ONLY = [(MATH_CALL, "")]
VARIANTS = {
    "kernel": [],
    "ring3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "ring5": [("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")],
    "lb1": [("__launch_bounds__(TXN_THREADS, txn_min_blocks(NT))",
             "__launch_bounds__(TXN_THREADS)")],
    "comb4": [("#pragma unroll 2\n  for (int t = 0; t < S; ++t) {",
               "#pragma unroll 4\n  for (int t = 0; t < S; ++t) {")],
    "magic": MAGIC,
    "shared_comb": [
        ("// qmm_common.cuh's split-K combine in float4 pieces",
         "struct TxnOff {\n  int Ns, n_base;\n  __device__ long long operator()(int i) const {\n"
         "    const int m = i / TN, c = n_base + i % TN;\n"
         "    return c < Ns ? (long long)m * Ns + c : -1;\n  }\n};\n\n"
         "// qmm_common.cuh's split-K combine in float4 pieces"),
        ("  if (!txn_combine<NT>(vals, M, partial, Ns, n_base, counters + tile, S, s)) return;",
         "  if (!splitk_combine(vals, M * TN, partial, (size_t)M * Ns, TxnOff{Ns, n_base},\n"
         "                      counters + tile, S, s))\n    return;")],
    "regpf": [
        ("    mma::cp_async16(p + w_dst, w, w_ok);\n",
         "    if (threadIdx.x < 64) {", "    (void)w;\n"),
        ("__device__ __forceinline__ void txn_math(const unsigned char* p, bool has_bias, "
         "float* acc) {",
         "__device__ __forceinline__ void txn_math(const unsigned char* p, bool has_bias, "
         "float* acc,\n                                         const uint32_t* w) {"),
        ("  uint32_t w[8];                                   // rows 4q + r", "  uint32_t cw[8];",
         ""),
        ("template <int NT>\n__global__", REGPF_LOAD),
        ("  for (int c = cb; c < ce; ++c) {",
         "  uint32_t wc[8];\n  if (cb < ce) txn_wload(a, cb, wc);\n"
         "  for (int c = cb; c < ce; ++c) {\n    uint32_t wn[8];\n"
         "    if (c + 1 < ce) txn_wload(a, c + 1, wn);"),
        (MATH_CALL, "    txn_math<NT>(stage(c), has_bias, acc, wc);\n#pragma unroll\n"
                    "    for (int i = 0; i < 8; ++i) wc[i] = wn[i];\n")],
    # dp4a holds 64 code registers: under the kernel's register caps it
    # spills, so it keeps ptxas's own budget
    "dp4a": [("// The math of one chunk", "// qmm_common.cuh's split-K combine", DP4A_MATH),
             ("__launch_bounds__(TXN_THREADS, txn_min_blocks(NT))",
              "__launch_bounds__(TXN_THREADS)")],
    "loads_only": LOADS_ONLY,
    "math_only": [("    if (c + STAGES - 1 < ce) cp.issue(a, c + STAGES - 1, "
                   "stage(c + STAGES - 1));\n", "")],
    "loads_w": LOADS_ONLY + [("    if (threadIdx.x < 64) {", "// The bias term's activation side",
                              "  }\n};\n\n")],
}
DIAGNOSTIC = ("loads_only", "math_only", "loads_w")   # timed, not checked
SPLITS = {"split2": 2, "split4": 4}           # timing variants of the kernel's library
TXN_SHAPES = [(32, "gate_up", 28672, 4096, 2), (32, "down", 4096, 14336, 3),
              (32, "qkv", 6144, 4096, 8), (32, "o", 4096, 4096, 12),
              (16, "gate_up", 28672, 4096, 2), (16, "down", 4096, 14336, 3),
              (8, "qkv", 6144, 4096, 8), (8, "o", 4096, 4096, 12),
              (8, "gate_up", 28672, 4096, 2), (8, "down", 4096, 14336, 3),
              (8, "lm_head", 129024, 4096, 1)]
G_SHAPES = [(8, 8), (256, 32)]                # (tokens, tm): 16 and 512 routed slots


def build(variants, parent, sass):
    """Build each variant's two sources at once; {(variant, entry): ctypes fn}.
    With sass, cuobjdump -sass of each variant's qmm_txn goes to sass/<variant>.sass."""
    from llamafile_tpu_torch.ops import _build
    base = os.path.join(_build.BUILD, "probe_txn")
    body = open(os.path.join(_build.CSRC, "qmm_txn.cuh")).read()
    entries = ("qmm_txn", "qmm_txn_g")
    jobs = {}
    for name in variants:
        text = probe_build.patched(body, VARIANTS[name], "qmm_txn.cuh")
        d = probe_build.variant_dir(
            base, name, probe_build.headers(_build.CSRC)
            + [os.path.join(_build.CSRC, f"{e}.cu") for e in entries], {"qmm_txn.cuh": text})
        for e in entries:
            jobs[f"{name}/{e}"] = (os.path.join(d, f"{e}.cu"), d)
    if parent:
        csrc = os.path.join(parent, "llamafile_tpu_torch", "csrc")
        for e in entries:
            jobs[f"parent/{e}"] = (os.path.join(csrc, f"{e}.cu"), csrc)
    out = os.path.join(base, "lib")
    libs = probe_build.build(jobs, out)
    if sass:
        os.makedirs(sass, exist_ok=True)
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        for key in jobs:
            if key.endswith("/qmm_txn"):
                with open(os.path.join(sass, key.split("/")[0] + ".sass"), "w") as f:
                    so = os.path.join(out, key.replace("/", "-") + ".so")
                    subprocess.run([tool, "-sass", so], stdout=f, check=True)
    P, I = _build.P, _build.I
    args = {"qmm_txn": [P] * 8 + [I] * 4 + [P], "qmm_txn_g": [P] * 9 + [I] * 5 + [P]}
    return {tuple(key.split("/")): probe_build.entry(lib, key.split("/")[1],
                                                     args[key.split("/")[1]])
            for key, lib in libs.items()}


def dequant_bf16(torch, qs, sc, b):
    """bf16 [L, K, N] of stacked q4b weights (qs [L, K/2, N])."""
    from llamafile_tpu_torch.ops.repack import q4b_codes
    k = qs.shape[-2] * 2
    w = q4b_codes(qs).float().reshape(qs.shape[0], k // 32, 32, -1)
    w = w * sc.float()[:, :, None] + b.float()[:, :, None]
    return w.reshape(qs.shape[0], k, -1).to(torch.bfloat16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose qmm_txn.cuh is timed as "
                                     "`parent`")
    ap.add_argument("--check", action="store_true", help="build and check only")
    ap.add_argument("--sass", help="write cuobjdump -sass of each variant's qmm_txn into "
                                   "this directory")
    ap.add_argument("--only", help="comma-separated variants to build and time (default all)")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.models.llama import group_layout
    from llamafile_tpu_torch.ops import _build
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b, rel_err

    if not torch.cuda.is_available():
        raise SystemExit("probe_txn: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    chosen = (args.only.split(",") if args.only
              else list(VARIANTS) + list(SPLITS))
    variants = ["kernel"] + [v for v in chosen
                             if v in VARIANTS and v != "kernel"]
    fns = build(variants, args.parent, args.sass)
    built = variants + (["parent"] if args.parent else [])
    names = ["kernel", *[v for v in chosen if v in SPLITS],
             *[v for v in built if v != "kernel"]]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    st = lambda: torch.cuda.current_stream().cuda_stream

    def splits(name, blocks, chunks):
        if name not in SPLITS:
            return Q.n_split(blocks, chunks, chunks, sms)
        return max(1, min(-(-SPLITS[name] * sms // blocks), chunks))

    def lib(name):
        return name if name in built else "kernel"

    def run_txn(name, xq, sx, qs, sc, b, out):
        m, k = xq.shape
        ns = qs.shape[-1]
        tiles = -(-ns // 128)
        s = splits(name, tiles, k // 64)
        y, partial = out(s)
        err = fns[(lib(name), "qmm_txn")](
            xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(), b.data_ptr(),
            y.data_ptr(), partial.data_ptr(), Q._counter_buf(dev, tiles).data_ptr(), m, k, ns,
            s, st())
        _build.check(err, f"probe_txn {name}")
        return y

    def run_g(name, xq, sx, qs, sc, b, te, tm, out):
        m, k = xq.shape
        tiles, ns = te.shape[0], qs.shape[-1]
        cols = -(-ns // 128)
        s = splits(name, cols * tiles, k // 64)
        y, partial = out(s)
        err = fns[(lib(name), "qmm_txn_g")](
            xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(), b.data_ptr(),
            y.data_ptr(), partial.data_ptr(), Q._counter_buf(dev, tiles * cols).data_ptr(),
            te.data_ptr(), tm, tiles, k, ns, s, st())
        _build.check(err, f"probe_txn {name}")
        return y

    def buffers(y_shape, partial_shape):
        """fn(s) -> (y, split-K scratch of s splits), each made once, before
        any graph capture."""
        y = torch.empty(y_shape, device=dev)
        cache = {}

        def out(s):
            if s not in cache:
                cache[s] = torch.empty(partial_shape(s), device=dev)
            return y, cache[s]
        return out

    def measure(what, check, timed, lib_ms, nbytes, ops, layers):
        rec = {"shape": what, "within_1e-5": [v for v in names if v not in DIAGNOSTIC],
               "bitwise_kernel": []}
        first = None
        for name in names:
            if name in DIAGNOSTIC:
                continue
            got, want = check(name)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            if not err <= 1e-5:
                raise AssertionError(f"probe_txn: {name} parts from the plain version at "
                                     f"{what}: {err:.3g} of the largest output")
            if first is None:
                first = got
            elif torch.equal(got, first):
                rec["bitwise_kernel"].append(name)
        print(f"{what}: bitwise equal to kernel: {' '.join(rec['bitwise_kernel'])}", flush=True)
        if args.check:
            print(f"{what}: every variant within 1e-5 of the plain version", flush=True)
            return rec
        ms = {name: [] for name in names}
        C.time_ms(torch, lambda i: timed(names[0], i), layers)      # warm-up, discarded
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(C.time_ms(torch, lambda i: timed(name, i), layers))
        rec["ms"] = ms
        rec["matmul_ms"] = lib_ms()
        bms, by = C.bound_ms(nbytes, ops)
        rec["bound_ms"], rec["bound_by"] = bms, by
        print(f"{what}: bound {bms:.4f} ms ({by}), library {rec['matmul_ms']:.4f} ms",
              flush=True)
        for name in names:
            a, c = ms[name]
            print(f"  {name:7s} {a:.4f} {c:.4f} ms", flush=True)
        return rec

    result = {"card": C.nvidia_smi(), "shapes": []}
    for m, label, n, k, layers in TXN_SHAPES:
        what = f"qmm_txn {label} M={m} N={n} K={k}"
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        out = buffers((m, n), lambda s: (s, m, n))
        want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b[0])
        w = None if args.check else dequant_bf16(torch, qs, sc, b)
        xb = x.to(torch.bfloat16)
        result["shapes"].append(measure(
            what, lambda name: (run_txn(name, xq, sx, qs[0], sc[0], b[0], out).clone(), want),
            lambda name, i: run_txn(name, xq, sx, qs[i], sc[i], b[i], out),
            lambda: C.time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers),
            C.q4b_bytes(qs, sc, b) + m * (k + k // 8) + 4 * m * n, 2 * m * n * k, layers))
        del qs, sc, b, w, want
        torch.cuda.empty_cache()

    E, d, dff = C.MOE_E, C.MOE_D, C.MOE_DFF
    gate_up, down = rand_q4b(gen, E, 2 * dff, d, dev), rand_q4b(gen, E, d, dff, dev)
    for n_tok, tm in G_SHAPES:
        gid = C.moe_slots(torch, n_tok, n_tok).to(dev)
        _, pos, te, n_tiles = group_layout(gid, E, tm)
        te = te.to(torch.int32)
        n_exp = int(te.unique().numel())
        for label, (qs, sc, b), k in (("gate_up", gate_up, d), ("down", down, dff)):
            n = qs.shape[-1]
            what = (f"qmm_txn_g {label} S={gid.shape[0]} tm={tm} ({n_tiles} tiles of {n_exp} "
                    f"experts) N={n} K={k}")
            x = torch.zeros((n_tiles * tm, k), device=dev).index_copy_(
                0, pos, torch.randn((gid.shape[0], k), generator=gen, device=dev))
            xq, sx = Q.quantize_activations_g32(x)
            out = buffers((n_tiles * tm, n), lambda s: (n_tiles, s, tm, n))
            want = Q.qmm_txn_g_plain(xq, sx, qs, sc, b, te, tm)
            wt = None if args.check else dequant_bf16(torch, qs, sc, b).index_select(
                0, te.long())
            xt = x.to(torch.bfloat16).reshape(n_tiles, tm, k)
            result["shapes"].append(measure(
                what, lambda name: (run_g(name, xq, sx, qs, sc, b, te, tm, out).clone(), want),
                lambda name, i: run_g(name, xq, sx, qs, sc, b, te, tm, out),
                lambda: C.time_ms(torch, lambda i: torch.bmm(xt, wt), 1),
                n_exp * C.q4b_bytes(qs, sc, b) + n_tiles * tm * (k + k // 8)
                + 4 * n_tiles * tm * n, 2 * n_tiles * tm * n * k, 1))
            del wt, want
            torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
