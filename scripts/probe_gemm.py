#!/usr/bin/env python3
"""Device times of the bf16-dequant GEMM body's design variants
(csrc/qmm_gemm.cuh under qmm_dequant, qmm_planes and qmm_planes_g), and of
the body they replaced, side by side on one card.

    python3 scripts/probe_gemm.py [--parent DIR] [--check]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Each variant's three C entries (csrc/qmm_dequant.cu,
qmm_planes.cu, qmm_planes_g.cu) are built with nvcc, all at once, under
llamafile_tpu_torch/build/probe_gemm/<variant>/, and ptxas's register,
spill and wgmma notes are printed. Each variant that computes the function
is then checked against the plain version at every shape (1e-3 of the
largest output, one bf16 step of it for bf16 outputs) and, on one-hot rows
of x (x = I, K = 1024), against dequant_bf16 exactly (q4b, q8b g32 and g16);
then the variants are timed as chip_smoke.py times a kernel (a run of
launches cycling over enough layers to spill the L2, captured into a CUDA
graph, the median of 25 replays), in the order below and then in reverse,
beside torch.matmul on the weights dequantized beforehand (torch.bmm on
each tile's expert for qmm_planes_g). The shapes are those chip_smoke.py's
phase 2 times for the four rows of the body: qmm_dequant q4b at M = 512,
1024, 2048 and q8b at M = 32, 512; qmm_planes at M = 1024 and 128, and on
layer 1 of a stack at M = 1024 and 8; qmm_planes_g at 2048 routed slots
(tm 128) of Mixtral-8x7B's widths. --check builds and checks only.

Variants:
  kernel        csrc/qmm_gemm.cuh as the port builds it (wgmma m64n128k16
                from shared memory; A and the raw codes and scales in
                3-stage cp.async rings, two and three steps ahead; the
                dequant of step ks + 1, codes built from their bits, beside
                step ks's wgmmas; two blocks an SM)
  wgmma_cvt     the kernel with the parent's dequant: int-to-float
                conversions, f32 products and one f32-to-bf16x2 pack a pair
                (and no two-blocks bound, which it would spill under)
  reg_raw       the kernel with the raw codes and scales in registers,
                loaded a step ahead, A and B in one 2-stage ring (each
                warpgroup waits for its wgmmas every step), a text patch
                of the kernel
  reg_raw_ring3 the same with a 3-stage ring whose warpgroups wait for all
                but their newest wgmma group before the barrier
  mma_only      timing only: the kernel with no raw copies and no dequant
                after the prologue (B keeps the first tile)
  dequant_only  timing only: the kernel's copies, dequant and barriers,
                no wgmma
  parent        with --parent DIR: the body of an unpacked checkout
                (DIR/llamafile_tpu_torch/csrc/), built with its own headers

The last line printed is one JSON object of every reading.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_build  # noqa: E402

ENTRIES = ("qmm_dequant", "qmm_planes", "qmm_planes_g")
TOL, BF16_TOL = 1e-3, 2 ** -7
TIMING_ONLY = ("mma_only", "dequant_only")

# the parent's dequant: conversions on the f32 path, one pack a pair
CVT_DEQUANT = r'''__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

template <bool Q4, int PLANE>
__device__ __forceinline__ float code_of(uint32_t w, int i) {
  const uint32_t b = (w >> (8 * i)) & 0xFFu;
  if (Q4) return PLANE == 0 ? (float)(b & 0x0Fu) : (float)(int8_t)((b ^ 0x80u) & 0xF0u);
  return (float)(int8_t)b;
}

template <bool Q4, int PLANE>
__device__ __forceinline__ void dequant16(uint4 code, uint4 s0, uint4 s1, uint32_t (&out)[8]) {
  const uint32_t cw[4] = {code.x, code.y, code.z, code.w};
  const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t w = cw[p >> 1];
    const int i = 2 * (p & 1);
    out[p] = pack_bf16x2(code_of<Q4, PLANE>(w, i) * bf16_lo(sw[p]),
                         code_of<Q4, PLANE>(w, i + 1) * bf16_hi(sw[p]));
  }
}

'''
DEQUANT_START = "template <bool Q4, int PLANE>\n__device__ __forceinline__ void dequant16("
DEQUANT_END = "// Dequantize this thread's share of the raw stage"

# reg_raw: each thread __ldg's its 16 columns of rows r and r + 32 (q4b: one
# packed row, both planes) and their scales into registers a step ahead;
# stages of [A | B] (B_BASE is stage 0's B, where bias_steps works).
REG_RAW_CONST = r'''constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int B_BASE = A_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
'''
REG_RAW_LOAD = r'''struct Raw {
  uint4 code[2];
  uint4 sc[2][2];
};

template <bool Q4, int G>
__device__ __forceinline__ void load_raw(Raw& raw, const uint8_t* qs,
                                         const __nv_bfloat16* sc, int ks, int Ns,
                                         int col, bool valid) {
  const int r = tile_row();
  int row0, row1, g0, g1;
  if (Q4) {
    const int sb = ks >> 2, j = ks & 3;
    row0 = 128 * sb + 32 * j + r;
    row1 = row0;
    g0 = 8 * sb + j;
    g1 = g0 + 4;
  } else {
    row0 = BK * ks + r;
    row1 = row0 + 32;
    g0 = row0 / G;
    g1 = row1 / G;
  }
  const uint4 z = make_uint4(0, 0, 0, 0);
  raw.code[0] = valid ? __ldg(reinterpret_cast<const uint4*>(qs + (size_t)row0 * Ns + col)) : z;
  raw.code[1] = (!Q4 && valid)
                    ? __ldg(reinterpret_cast<const uint4*>(qs + (size_t)row1 * Ns + col))
                    : z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* s0 = sc + (size_t)(h ? g1 : g0) * Ns + col;
    raw.sc[h][0] = valid ? __ldg(reinterpret_cast<const uint4*>(s0)) : z;
    raw.sc[h][1] = valid ? __ldg(reinterpret_cast<const uint4*>(s0 + 8)) : z;
  }
}

'''
REG_RAW_STORE = r'''template <bool Q4>
__device__ __forceinline__ void store_tile(const Raw& raw, unsigned char* Bs) {
  const int r = tile_row(), seg = tile_seg();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t o[8];
    if (Q4) {
      if (h == 0)
        dequant16<true, 0>(raw.code[0], raw.sc[0][0], raw.sc[0][1], o);
      else
        dequant16<true, 1>(raw.code[0], raw.sc[1][0], raw.sc[1][1], o);
    } else {
      dequant16<false, 0>(raw.code[h], raw.sc[h][0], raw.sc[h][1], o);
    }
    st16(Bs + b_off(r + 32 * h, 2 * seg), o[0], o[1], o[2], o[3]);
    st16(Bs + b_off(r + 32 * h, 2 * seg + 1), o[4], o[5], o[6], o[7]);
  }
}

'''
REG_RAW_LOOP = r'''  const int col = n0 + 16 * tile_seg();
  const bool col_ok = col < Ns;
  Raw raw;
  load_a<Q4>(x, smem, 0, m0, M, K);
  cp_async_commit();
  load_raw<Q4, G>(raw, qs, sc, 0, Ns, col, col_ok);
  store_tile<Q4>(raw, smem + A_BYTES);
  if (nk > 1) load_raw<Q4, G>(raw, qs, sc, 1, Ns, col, col_ok);
  end_step<0>(acc);

  for (int ks = 0; ks < nk; ++ks) {
    const uint32_t cur = s0 + (ks % STAGES) * STAGE_BYTES;
    if (active) mma_stage(acc, cur, cur + A_BYTES, wg);
    if (ks + 1 < nk) {
      unsigned char* nxt = smem + ((ks + 1) % STAGES) * STAGE_BYTES;
      load_a<Q4>(x, nxt, ks + 1, m0, M, K);
      cp_async_commit();
      store_tile<Q4>(raw, nxt + A_BYTES);
      if (ks + 2 < nk) load_raw<Q4, G>(raw, qs, sc, ks + 2, Ns, col, col_ok);
    }
    end_step<STAGES - 2>(acc);
  }
  if (bias != nullptr)
    bias_steps(bx, bias, smem, m0, M, K / 32, Ns, n0, active, wg, acc);
  wgmma::wait<0>();
  wgmma::fence_operands(acc);

'''
TWO_BLOCKS = ("__global__ void __launch_bounds__(THREADS, 2)\n",
              "__global__ void __launch_bounds__(THREADS)\n")

# name -> (base variant, substitutions as probe_build.patched takes them)
PATCHES = {
    "reg_raw": ("kernel", [
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
        ("constexpr int RAW_SC = 8192;", "\n// Byte offset of 16-byte chunk c (8 bf16)",
         REG_RAW_CONST),
        ("// Byte offset of 16-byte chunk c of code row", "__device__ __forceinline__ "
         "__nv_bfloat162 as_bf162", REG_RAW_LOAD),
        ("// Dequantize this thread's share of the raw stage", "// Activations of K step ks",
         REG_RAW_STORE),
        ("  wgmma::wait<0>();\n  wgmma::fence_operands(acc);\n  cp_async_wait<C>();",
         "  wgmma::wait<C>();\n  wgmma::fence_operands(acc);\n  cp_async_wait_all();"),
        ("  for (int kb = 0; kb < KG; kb += BK) {\n",
         "  end_step<0>(acc);                  // the main loop's stages are free\n"
         "  for (int kb = 0; kb < KG; kb += BK) {\n"),
        TWO_BLOCKS,
        ("  // cp.async groups: the prologue's", "  const int lane = threadIdx.x & 31",
         REG_RAW_LOOP)]),
    "reg_raw_ring3": ("reg_raw", [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")]),
    "mma_only": ("kernel", [
        ("    if (ks + 3 < nk) load_raw<Q4, G>(raw_s + (ks % STAGES) * RAW_BYTES, qs, sc, ks + 3, "
         "Ns, n0);\n", ""),
        ("    if (ks + 1 < nk)\n      store_tile<Q4, G>(raw_s + ((ks + 1) % STAGES) * RAW_BYTES,\n"
         "                        smem + B_BASE + ((ks + 1) & 1) * B_BYTES);\n", "")]),
    "dequant_only": ("kernel", [
        ("    if (active)\n      mma_stage(acc, s0 + (ks % STAGES) * A_BYTES, s0 + B_BASE + "
         "(ks & 1) * B_BYTES, wg);\n", "")]),
}


def variant_dirs(parent):
    """name -> directory holding that variant's headers and C entries."""
    from llamafile_tpu_torch.ops import _build
    base = os.path.join(_build.BUILD, "probe_gemm")
    body = open(os.path.join(_build.CSRC, "qmm_gemm.cuh")).read()
    i, j = body.index(DEQUANT_START), body.index(DEQUANT_END)
    patched = lambda text, subs: probe_build.patched(text, subs, "the body")
    texts = {"kernel": body,
             "wgmma_cvt": patched(body[:i] + CVT_DEQUANT + body[j:], [TWO_BLOCKS])}
    for name, (of, subs) in PATCHES.items():
        texts[name] = patched(texts[of], subs)
    copies = probe_build.headers(_build.CSRC) + [
        os.path.join(_build.CSRC, f"{e}.cu") for e in ENTRIES]
    dirs = {name: probe_build.variant_dir(base, name, copies, {"qmm_gemm.cuh": text})
            for name, text in texts.items()}
    if parent:
        dirs["parent"] = os.path.join(parent, "llamafile_tpu_torch", "csrc")
    return dirs


def build(dirs):
    """Compile every (variant, entry) at once; name -> {entry: ctypes fn}."""
    from llamafile_tpu_torch.ops import _build
    libs = probe_build.build({f"{name}/{e}": (os.path.join(d, f"{e}.cu"), d)
                              for name, d in dirs.items() for e in ENTRIES},
                             os.path.join(_build.BUILD, "probe_gemm", "lib"))
    argtypes = {"qmm_dequant": [_build.P] * 4 + [_build.I] * 5 + [_build.P],
                "qmm_planes": [_build.P] * 4 + [_build.I] * 4 + [_build.P],
                "qmm_planes_g": [_build.P] * 7 + [_build.I] * 4 + [_build.P]}
    return {name: {e: probe_build.entry(libs[f"{name}/{e}"], e, argtypes[e]) for e in ENTRIES}
            for name in dirs}


def shapes():
    """(row, entry, kind, label, m, n, k, layers, li): chip_smoke.py's phase-2
    shapes of rows 9, 11, 12 (li 1) and 20."""
    out = []
    for kind, m, label, n, k, layers in (
            ("q4b", 1024, "gate_up", 28672, 4096, 2), ("q4b", 1024, "down", 4096, 14336, 3),
            ("q4b", 1024, "qkv", 6144, 4096, 8), ("q4b", 1024, "o", 4096, 4096, 12),
            ("q4b", 512, "gate_up", 28672, 4096, 2), ("q4b", 512, "down", 4096, 14336, 3),
            ("q4b", 512, "qkv", 6144, 4096, 8), ("q4b", 512, "o", 4096, 4096, 12),
            ("q4b", 2048, "gate_up", 28672, 4096, 2), ("q4b", 2048, "down", 4096, 14336, 3),
            ("q4b", 2048, "qkv", 6144, 4096, 8), ("q4b", 2048, "o", 4096, 4096, 12),
            ("q8b", 32, "gate_up", 28672, 4096, 2), ("q8b", 32, "down", 4096, 14336, 2),
            ("q8b", 32, "qkv", 6144, 4096, 8), ("q8b", 32, "o", 4096, 4096, 12),
            ("q8b", 512, "gate_up", 28672, 4096, 2), ("q8b", 512, "down", 4096, 14336, 2)):
        out.append((9, "qmm_dequant", kind, label, m, n, k, layers, 0))
    for m, label, n, k, layers, li in ((1024, "gate_up", 28672, 4096, 2, 0),
                                       (1024, "down", 4096, 14336, 3, 0),
                                       (1024, "qkv", 6144, 4096, 8, 0),
                                       (1024, "o", 4096, 4096, 12, 0),
                                       (128, "qkv", 6144, 4096, 8, 0),
                                       (1024, "gate_up", 28672, 4096, 2, 1),
                                       (8, "gate_up", 28672, 4096, 2, 1)):
        out.append((12 if li else 11, "qmm_planes", "q4b", label, m, n, k, layers, li))
    out.append((20, "qmm_planes_g", "q4b", "gate_up", 2048, 28672, 4096, 1, 0))
    out.append((20, "qmm_planes_g", "q4b", "down", 2048, 4096, 14336, 1, 0))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose qmm_gemm.cuh body is "
                                     "timed as `parent`")
    ap.add_argument("--check", action="store_true", help="build and check only")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.models.llama import group_layout
    from llamafile_tpu_torch.ops import _build
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b, rand_q8b, rel_err

    if not torch.cuda.is_available():
        raise SystemExit("probe_gemm: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    fns = build(variant_dirs(args.parent))
    names = list(fns)
    checked = [n for n in names if n not in TIMING_ONLY]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    st = lambda: torch.cuda.current_stream().cuda_stream
    check = _build.check

    def dequant(f, x, qs, sc, m, k, ns, q4):
        y = torch.empty((m, ns), dtype=torch.float32, device=dev)
        check(f["qmm_dequant"](x.data_ptr(), qs.data_ptr(), sc.data_ptr(), y.data_ptr(), m, k,
                               ns, k // sc.shape[0], int(q4), st()), "probe_gemm")
        return y

    def planes(f, x, qs, sc, m, k, ns, y):
        check(f["qmm_planes"](x.data_ptr(), qs.data_ptr(), sc.data_ptr(), y.data_ptr(), m, k,
                              ns, int(y.dtype == torch.bfloat16), st()), "probe_gemm")
        return y

    def planes_g(f, x, qs, sc, te, bx, b, k, ns, y):
        check(f["qmm_planes_g"](x.data_ptr(), qs.data_ptr(), sc.data_ptr(), te.data_ptr(),
                                bx.data_ptr(), b.data_ptr(), y.data_ptr(), te.shape[0], k, ns,
                                int(y.dtype == torch.bfloat16), st()), "probe_gemm")
        return y

    # one-hot rows: y = dequant_bf16(W) exactly, each sum having one term
    k, n = 1024, 1040
    eye = torch.eye(k, device=dev, dtype=torch.bfloat16)
    for kind in ("q4b", "q8b32", "q8b16"):
        if kind == "q4b":
            qs, sc, _ = rand_q4b(gen, 1, n, k, dev)
        else:
            qs, sc, _ = rand_q8b(gen, 1, n, k, int(kind[3:]), dev)
        want = Q.dequant_bf16(qs[0], sc[0]).float()
        for name in checked:
            outs = [dequant(fns[name], eye, qs[0], sc[0], k, k, n, kind == "q4b")]
            if kind == "q4b":            # the planes entry too (bf16 out at M = 1024)
                outs.append(planes(fns[name], eye, qs[0], sc[0], k, k, n,
                                   torch.empty((k, n), dtype=torch.bfloat16, device=dev)))
            torch.cuda.synchronize()
            for got in outs:
                if not torch.equal(got.float(), want):
                    bad = (got.float() != want).nonzero()
                    raise AssertionError(
                        f"probe_gemm: {name} one-hot {kind}: {bad.shape[0]} elements differ "
                        f"from dequant_bf16, first {bad[:4].tolist()}")
        print(f"one-hot {kind} K={k} N={n}: every checked variant equals dequant_bf16",
              flush=True)

    result = {"card": C.nvidia_smi(), "shapes": []}
    for row, entry, kind, label, m, n, k, layers, li in shapes():
        what = f"row {row} {entry} {kind} {label} M={m} N={n} K={k}" + (
            f" layer {li} of {layers}" if li else "")
        if entry == "qmm_planes_g":
            gid = C.moe_slots(torch, m // 2, m // 2).to(dev)
            _, pos, te, n_tiles = group_layout(gid, C.MOE_E, 128)
            te = te.to(torch.int32)
            qs, sc, b = rand_q4b(gen, C.MOE_E, n, k, dev)
            x = torch.zeros((n_tiles * 128, k), device=dev).index_copy_(
                0, pos, torch.randn((gid.shape[0], k), generator=gen, device=dev))
            bx = Q.group_sums_bf16(x).contiguous()
            xb = x.to(torch.bfloat16)
            y = torch.empty((n_tiles * 128, n), dtype=torch.bfloat16, device=dev)
            run = lambda f, i: planes_g(f, xb, qs, sc, te, bx, b, k, n, y)
            want = Q.qmm_planes_g_plain(x, qs, sc, b, te)
            wt = torch.stack([Q.dequant_bf16(qs[e], sc[e]) for e in range(C.MOE_E)]
                             ).index_select(0, te.long())
            xt = xb.reshape(n_tiles, 128, k)
            lib = lambda i: torch.bmm(xt, wt)
            what += f" ({n_tiles} tiles)"
        else:
            if kind == "q4b":
                qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
            else:
                qs, sc, _ = rand_q8b(gen, layers, n, k, 32, dev)
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            if entry == "qmm_dequant":
                run = lambda f, i: dequant(f, xb, qs[i], sc[i], m, k, n, kind == "q4b")
                want = Q.qmm_dequant_plain(xb, qs[li], sc[li])
            else:
                y = torch.empty((m, n), device=dev, dtype=torch.bfloat16
                                if Q.planes_bf16_out(m) else torch.float32)
                run = lambda f, i: planes(f, xb, qs[i], sc[i], m, k, n, y)
                want = Q.qmm_planes_plain(xb, qs[li], sc[li])
            wt = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
            lib = lambda i: torch.matmul(xb, wt[i])
        tol = BF16_TOL if want.dtype == torch.bfloat16 else TOL
        errs = {}
        for name in checked:
            got = run(fns[name], li).clone()
            torch.cuda.synchronize()
            e = rel_err(got, want)
            if not e <= tol:
                raise AssertionError(f"probe_gemm: {name} disagrees with the plain version "
                                     f"at {what}: {e} > {tol}")
            errs[name] = (got.float() - want.float()).abs().max().item()
        del want
        rec = {"row": row, "shape": what, "max_abs_err": errs}
        if not args.check:
            cycle = layers if entry != "qmm_planes_g" else 1
            ms = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    ms[name].append(C.time_ms(torch, lambda i: run(fns[name], i), cycle))
            rec["ms"] = ms
            rec["library_ms"] = C.time_ms(torch, lib, cycle)
            print(f"{what}: library {rec['library_ms']:.4f} ms", flush=True)
            for name in names:
                a, c = ms[name]
                print(f"  {name:13s} {a:.4f} {c:.4f} ms"
                      + (f"  (max_abs_err {errs[name]:.3g})" if name in errs else ""),
                      flush=True)
        else:
            print(f"{what}: " + ", ".join(f"{k_} {v:.3g}" for k_, v in errs.items()),
                  flush=True)
        result["shapes"].append(rec)
        del qs, sc, wt, run, lib
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
