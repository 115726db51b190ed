#!/usr/bin/env python3
"""Device times of the M = 1 q4b GEMV body's design variants
(csrc/qmm_m1.cuh under qmm_txn_m1, qmm_moe_m1 and qmm_txn_m1_r), of the
body it replaced, of qmm_int8 on the small-M body (csrc/qmm_txn.cuh with
no bias) against its earlier kernel, and of their yardsticks, side by side
on one card.

    python3 scripts/probe_gemv.py [--parent DIR] [--check] [--only V,...]
                                  [--part A|B|AB] [--out FILE] [--sass DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Each variant's C entries are built with nvcc, all at once, under
llamafile_tpu_torch/build/probe_gemv/<variant>/, and ptxas's register and
spill notes are printed. Every variant but the diagnostic ones is checked
against the plain version at every shape (1e-5 of the largest output for
the GEMVs and qmm_int8, 2e-3 for the fused FFN, whose requantized
intermediate may move a code), a second launch of each must give the same
bits, and its bit-for-bit agreement with `kernel` is reported; then all are
timed as chip_smoke.py times a kernel (a run of launches cycling over
enough layers of a stack to spill the L2, captured into a CUDA graph, the
median of 25 replays), after one discarded warm-up reading, in the order
below and then in reverse, beside torch.matmul on the weights dequantized
to bf16 beforehand (torch.bmm on the two routed experts) and the bytes
bound.

Part B, the M = 1 body, at chip_smoke.py phase 2's shapes: qmm_txn_m1 at
llama3-8b's qkv, o, down (K = 14336) and lm head; qmm_moe_m1 as the dense
FFN (the layer as its one expert) and as Mixtral-8x7B's routed step of 2
slots; qmm_txn_m1_r at that step's gate|up and down. Variants:
  kernel     csrc/qmm_m1.cuh as the port builds it (a 2-stage cp.async
             ring a warp of 4, the activations staged once a block, a column
             tile's K splits one cluster summed through distributed shared
             memory; the split of ops.qmatmul.m1_split)
  pull       split 0 reads every block's values through distributed shared
             memory between two full cluster barriers (the kernel: each block
             pushes its values to split 0, one phase at the end)
  lop3       the hi plane's mask and sign flip in one lop3 instruction
  hiu8       the hi plane on a mixed-sign dp4a (unsigned 16q against the
             signed codes, less 128 x the codes' sum): the same dots, one
             instruction less a code word
  ring3, ring4  a 3- and a 4-stage ring a warp, at the kernel's splits
  ring2_wide the kernel at the splits of twice its bytes in flight
  s1, s2, s4 the kernel with K split for 1, 2 and 4 blocks an SM (at most 8)
  loads_only diagnostic: the kernel's grid and copies, no math, no combine
  no_combine diagnostic: the kernel without the split-K sum
  read_floor diagnostic: the best of a few grid shapes of a kernel that
             only reads the same bytes (16-byte loads, four in flight a
             thread) and writes one word a block: the floor of such a
             stream on this card, launch and ramp included
  parent     with --parent DIR: the body of an unpacked checkout
             (DIR/llamafile_tpu_torch/csrc/), built with its own headers,
             at its own split (3 blocks an SM, at most K/64/8)
  parent_loads  diagnostic: the parent with its __dp4a math replaced by an
             XOR of the loaded words (the loads, scales and combine stay)
  parent_no_combine  diagnostic: the parent without its split-K combine

Part A, qmm_int8 at chip_smoke.py phase 2's seven shapes (M = 8: qkv, o,
gate|up, down, lm head; M = 32: gate|up, down), on layer i > 0 of a stack:
  kernel     csrc/qmm_int8.cu as the port builds it (qmm_txn.cuh's body with
             no bias term, ops.qmatmul.txn_split)
  split2, split4  the kernel with K split for 2 and 4 blocks an SM
  txn        qmm_txn with the bias term at the same shape (a yardstick)
  parent     with --parent DIR: that checkout's qmm_int8.cu at its split
             (32-column tiles, 3 blocks an SM, at most K/64/8)

--only names the variants to time (read_floor among them); every variant
is built and checked all the same.

The last line printed is one JSON object of every reading (also written to
--out).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_build  # noqa: E402

MATH_CALL = ("    m1_math(stage(t), xs + 256 * q, sxs + 8 * q, bss + 8 * q, c & 3, has_bias, "
             "acc);\n")
NO_COMBINE = [("  cluster_arrive_relaxed();             // this block runs (m1_cluster_sum)\n", ""),
              ("  return m1_cluster_sum(vals, S, s);", "  __syncthreads();\n  return s == 0;")]
# pull: split 0 reads the other blocks' vals through distributed shared
# memory between two full cluster barriers
PULL_SUM = r'''__device__ __forceinline__ bool m1_cluster_sum(float* vals, int S, int s) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  cl.sync();
  if (s == 0)
    for (int i = threadIdx.x; i < TN; i += M1_THREADS) {
      float v = 0.f;
      for (int r = 0; r < S; ++r) v += cl.map_shared_rank(vals, r)[i];
      vals[i] = v;
    }
  cl.sync();
  return s == 0;
}

'''
PULL = [("__device__ __forceinline__ bool m1_cluster_sum(float* vals, int S, int s) {",
         "// The M = 1 product of one block over chunks", PULL_SUM),
        ("  cluster_arrive_relaxed();             // this block runs (m1_cluster_sum)\n", "")]
# hiu8: the hi plane's codes as unsigned 16q (0..240) against the signed
# activations (mixed-sign dp4a), less 128 x the group's code sum: the same
# exact int32 dot, one instruction less a code word
HIU8 = [
    ("      dhi[cc] = __dp4a(hi_plane(col[cc]), xhi[t], dhi[cc]);",
     "      asm(\"dp4a.u32.s32 %0, %1, %2, %0;\" : \"+r\"(dhi[cc]) : \"r\"(col[cc] & 0xF0F0F0F0u),"
     " \"r\"(xhi[t]));"),
    ("  const float sxl = sxs[j], sxh = sxs[4 + j];",
     "  int shi = 0;\n#pragma unroll\n  for (int t = 0; t < 8; ++t) shi = __dp4a(xhi[t], 0x01010101, shi);\n"
     "#pragma unroll\n  for (int cc = 0; cc < 4; ++cc) dhi[cc] -= 128 * shi;\n"
     "  const float sxl = sxs[j], sxh = sxs[4 + j];")]
# lop3: the hi plane's code word in one three-input logic instruction,
# (p ^ 0x80808080) & 0xF0F0F0F0 (ptxas makes it two): the same codes
LOP3 = [
    ("// The math of one chunk (group j of a superblock)",
     "// lop3: (p ^ 0x80808080) & 0xF0F0F0F0 in one instruction.\n"
     "__device__ __forceinline__ int m1_hi(uint32_t p) {\n  uint32_t r;\n"
     "  asm(\"lop3.b32 %0, %1, %2, %3, 0x28;\" : \"=r\"(r) : \"r\"(p), \"n\"(0x80808080), "
     "\"r\"(0xF0F0F0F0u));\n  return (int)r;\n}\n\n"
     "// The math of one chunk (group j of a superblock)"),
    ("      dhi[cc] = __dp4a(hi_plane(col[cc]), xhi[t], dhi[cc]);",
     "      dhi[cc] = __dp4a(m1_hi(col[cc]), xhi[t], dhi[cc]);")]
VARIANTS = {
    "kernel": [],
    "hiu8": HIU8,
    "lop3": LOP3,
    "pull": PULL,
    "ring3": [("constexpr int M1_STAGES = 2;", "constexpr int M1_STAGES = 3;")],
    "ring4": [("constexpr int M1_STAGES = 2;", "constexpr int M1_STAGES = 4;")],
    "loads_only": [(MATH_CALL, "")] + NO_COMBINE,
    "no_combine": NO_COMBINE,
}
# (stages, bytes in flight an SM) of the ring variants' splits: ring3 and
# ring4 keep the kernel's splits, ring2_wide takes twice its bytes in flight
RING = {"ring3": (3, 48 * 1024), "ring4": (4, 72 * 1024), "ring2_wide": (2, 48 * 1024)}
SPLITS = {"s1": 1, "s2": 2, "s4": 4}            # blocks an SM
DIAGNOSTIC = ("loads_only", "no_combine", "read_floor", "parent_loads", "parent_no_combine")

# the parent's body (qmm_common.cuh m1_chunk, m1_gemv_kernel), patched
PARENT_LOADS = [("  for (int t = 0; t < 8; ++t) {\n    uint32_t col[4];\n"
                 "    transpose4x4(&w[4 * t], col);",
                 "  const float sxl = __ldg(sx + g_lo)",
                 "  for (int t = 0; t < CHUNK_ROWS; ++t)\n"
                 "    dlo[t & 3] ^= (int)w[t] ^ xlo[t & 7] ^ xhi[t & 7];\n")]
PARENT_NO_COMBINE = [("  if (!splitk_combine(vals, TN, partial, (size_t)Ns, M1Off{n_base, Ns},\n"
                      "                      counters + tile, S, s))\n    return;",
                      "  __syncthreads();\n  if (s != 0) return;")]
PARENT_VARIANTS = {"parent": [], "parent_loads": PARENT_LOADS,
                   "parent_no_combine": PARENT_NO_COMBINE}

READ_FLOOR = r'''// Reads three arrays in 16-byte words (four loads in flight a thread) and
// writes one word a block: the floor of a stream of the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void read_floor_kernel(const uint4* a, long long na, const uint4* b, long long nb,
                                  const uint4* c, long long nc, unsigned* out) {
  const long long n = na + nb + nc, stride = (long long)gridDim.x * blockDim.x;
  unsigned acc = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long k = i + u * stride;
      v[u] = k < na ? __ldg(a + k) : k < na + nb ? __ldg(b + (k - na))
           : k < n ? __ldg(c + (k - na - nb)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ unsigned w[32];
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) acc ^= w[i];
    out[blockIdx.x] = acc;
  }
}

extern "C" int read_floor(const void* a, long long na, const void* b, long long nb,
                          const void* c, long long nc, void* out, int blocks, int threads,
                          void* stream) {
  read_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, na, (const uint4*)b, nb, (const uint4*)c, nc, (unsigned*)out);
  return (int)cudaGetLastError();
}
'''
FLOOR_GRIDS = [(1, 1024), (2, 512), (4, 256), (8, 256), (2, 1024)]   # (blocks an SM, threads)

M1_SHAPES = [("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12), ("down", 4096, 14336, 3),
             ("lm_head", 129024, 4096, 1)]
INT8_SHAPES = [(8, "gate_up", 28672, 4096, 2), (8, "down", 4096, 14336, 3),
               (8, "qkv", 6144, 4096, 8), (8, "o", 4096, 4096, 12),
               (8, "lm_head", 129024, 4096, 1), (32, "gate_up", 28672, 4096, 2),
               (32, "down", 4096, 14336, 3)]
INT8_SPLITS = {"split2": 2, "split4": 4}
M1_ENTRIES = ("qmm_txn_m1", "qmm_moe_m1", "qmm_routed")


def build(variants, parent_variants, parent, with_int8, sass=None):
    """Build every variant's entries at once; {(variant, symbol): ctypes fn}."""
    from llamafile_tpu_torch.ops import _build
    base = os.path.join(_build.BUILD, "probe_gemv")
    body = open(os.path.join(_build.CSRC, "qmm_m1.cuh")).read()
    jobs = {}
    for name in variants:
        texts = {"qmm_m1.cuh": probe_build.patched(body, VARIANTS[name], "qmm_m1.cuh")}
        d = probe_build.variant_dir(
            base, name, probe_build.headers(_build.CSRC)
            + [os.path.join(_build.CSRC, f"{e}.cu") for e in M1_ENTRIES], texts)
        for e in M1_ENTRIES:
            jobs[f"{name}/{e}"] = (os.path.join(d, f"{e}.cu"), d)
    if with_int8:
        jobs["kernel/qmm_int8"] = (os.path.join(_build.CSRC, "qmm_int8.cu"), _build.CSRC)
    d = probe_build.variant_dir(base, "read_floor", [], {"read_floor.cu": READ_FLOOR})
    jobs["read_floor/read_floor"] = (os.path.join(d, "read_floor.cu"), d)
    if parent:
        csrc = os.path.join(parent, "llamafile_tpu_torch", "csrc")
        common = open(os.path.join(csrc, "qmm_common.cuh")).read()
        for name in parent_variants:
            d = probe_build.variant_dir(
                base, name, probe_build.headers(csrc)
                + [os.path.join(csrc, f"{e}.cu") for e in M1_ENTRIES],
                {"qmm_common.cuh": probe_build.patched(common, PARENT_VARIANTS[name],
                                                       "the parent's qmm_common.cuh")})
            for e in M1_ENTRIES:
                jobs[f"{name}/{e}"] = (os.path.join(d, f"{e}.cu"), d)
        if with_int8:
            jobs["parent/qmm_int8"] = (os.path.join(csrc, "qmm_int8.cu"), csrc)
    libs = probe_build.build(jobs, os.path.join(base, "lib"))
    if sass:
        os.makedirs(sass, exist_ok=True)
        import subprocess
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        for key in jobs:
            if key.endswith("/qmm_txn_m1"):
                with open(os.path.join(sass, key.split("/")[0] + ".sass"), "w") as f:
                    so = os.path.join(base, "lib", key.replace("/", "-") + ".so")
                    subprocess.run([tool, "-sass", so], stdout=f, check=True)
    P, I = _build.P, _build.I
    import ctypes
    L = ctypes.c_longlong
    args = {"qmm_txn_m1": [P] * 6 + [I] * 3 + [P],
            "qmm_moe_m1": [P] * 14 + [I] * 6 + [P],
            "qmm_txn_m1_r": [P] * 8 + [I] * 4 + [P],
            "qmm_int8": [P] * 7 + [I] * 4 + [P],
            "read_floor": [P, L, P, L, P, L, P, I, I, P]}
    old = {"qmm_txn_m1": [P] * 8 + [I] * 3 + [P], "qmm_moe_m1": [P] * 17 + [I] * 6 + [P],
           "qmm_txn_m1_r": [P] * 10 + [I] * 4 + [P]}        # the parent's (split-K scratch)
    fns = {}
    for key, lib in libs.items():
        name, src = key.split("/")
        for sym in (("qmm_txn_m1_r",) if src == "qmm_routed" else (src,)):
            fns[(name, sym)] = probe_build.entry(
                lib, sym, old.get(sym, args[sym]) if name.startswith("parent") else args[sym])
    return fns


def dequant_bf16(torch, qs, sc, b):
    """bf16 [L, K, N] of stacked q4b weights (qs [L, K/2, N])."""
    from llamafile_tpu_torch.ops.repack import q4b_codes
    k = qs.shape[-2] * 2
    w = q4b_codes(qs).float().reshape(qs.shape[0], k // 32, 32, -1)
    w = w * sc.float()[:, :, None] + b.float()[:, :, None]
    return w.reshape(qs.shape[0], k, -1).to(torch.bfloat16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose M = 1 body and qmm_int8 are "
                                     "timed as `parent`")
    ap.add_argument("--check", action="store_true", help="build and check only")
    ap.add_argument("--only", help="comma-separated variants to time (default all); every "
                                   "variant is built and checked")
    ap.add_argument("--part", default="AB", help="A (qmm_int8), B (the M = 1 body) or AB")
    ap.add_argument("--out", help="also write the JSON of every reading here")
    ap.add_argument("--sass", help="write cuobjdump -sass of each variant's qmm_txn_m1 into "
                                   "this directory")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import _build
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b, rel_err

    if not torch.cuda.is_available():
        raise SystemExit("probe_gemv: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    chosen = args.only.split(",") if args.only else None
    b_names = ["kernel", "pull", "lop3", "hiu8", *RING, *SPLITS, "loads_only", "no_combine", "read_floor",
               *(PARENT_VARIANTS if args.parent else ())]
    a_names = ["kernel", *INT8_SPLITS, "txn", *(("parent",) if args.parent else ())]
    fns = build(list(VARIANTS), list(PARENT_VARIANTS) if args.parent else [], args.parent,
                "A" in args.part, args.sass)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    st = lambda: torch.cuda.current_stream().cuda_stream

    def lib(name):
        return name if name in VARIANTS or name in PARENT_VARIANTS else "kernel"

    def m1_s(name, tiles, chunks):
        """The K split that variant `name` takes for `tiles` blocks a split."""
        if name in SPLITS:
            return max(1, min(-(-SPLITS[name] * sms // tiles), chunks // Q.M1_WARPS,
                              Q.M1_MAX_SPLITS))
        if name.startswith("parent"):
            return Q.n_split(tiles, chunks, chunks // 8, sms)
        if name in RING:
            # ops.qmatmul.m1_split's rule at the variant's ring depth and bytes in flight
            stages, in_flight = RING[name]
            ahead = Q.M1_WARPS * (stages - 1)
            blocks = -(-sms * in_flight // (ahead * Q.M1_STAGE_BYTES))
            return max(1, min(-(-blocks // tiles), chunks // ahead, Q.M1_MAX_SPLITS))
        return Q.m1_split(tiles, chunks, sms)

    scratch = {}

    def buf(shape, dtype=torch.float32):
        """A device buffer of `shape`, made once (before any graph capture)."""
        key = (tuple(shape), dtype)
        if key not in scratch:
            scratch[key] = torch.empty(shape, dtype=dtype, device=dev)
        return scratch[key]

    def floor_fn(arrays):
        """fn(blocks a SM, threads) -> fn(i) reading layer i of the arrays."""
        out = buf((8 * sms,), torch.int32)

        def make(per_sm, threads):
            def run(i):
                a, b, c = (t[i] for t in arrays)
                err = fns[("read_floor", "read_floor")](
                    a.data_ptr(), a.numel() * a.element_size() // 16, b.data_ptr(),
                    b.numel() * b.element_size() // 16, c.data_ptr(),
                    c.numel() * c.element_size() // 16, out.data_ptr(), per_sm * sms, threads,
                    st())
                _build.check(err, "probe_gemv read_floor")
            return run
        return make

    def gemv(name, xq, sx, qs, sc, b, y_rows=1, ei=None, ti=None):
        """One qmm_txn_m1 (ei None) or qmm_txn_m1_r launch of variant name."""
        k, ns = xq.shape[1], qs.shape[-1]
        slots = 1 if ei is None else ei.shape[0]
        tiles = -(-ns // 128)
        s = m1_s(name, tiles * slots, k // 64)
        y = buf((slots, ns))
        head = (xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(), b.data_ptr(),
                y.data_ptr())
        scratch_args = ()
        if name.startswith("parent"):
            scratch_args = (buf((slots, s, ns)).data_ptr(),
                            Q._counter_buf(dev, tiles * slots).data_ptr())
        if ei is None:
            err = fns[(lib(name), "qmm_txn_m1")](*head, *scratch_args, k, ns, s, st())
        else:
            err = fns[(lib(name), "qmm_txn_m1_r")](*head, *scratch_args, ei.data_ptr(),
                                                   ti.data_ptr(), k, ns, s, slots, st())
        _build.check(err, f"probe_gemv {name}")
        return y

    def moe(name, xq, sx, gu, dn, ei, ti, topw):
        (gq, gs, gb), (dq, ds, db) = gu, dn
        k, n_gu, nd = xq.shape[1], gq.shape[-1], dq.shape[-1]
        dff, slots = n_gu // 2, ei.shape[0]
        sa = m1_s(name, n_gu // 128 * slots, k // 64)
        sb = m1_s(name, -(-nd // 128) * slots, dff // 64)
        yq, sy = buf((slots, dff), torch.int8), buf((slots, dff // 32))
        out = buf((slots, nd))
        scratch_args = ()
        if name.startswith("parent"):
            scratch_args = (buf((slots, sa, n_gu)).data_ptr(), buf((slots, sb, nd)).data_ptr(),
                            Q._counter_buf(dev, slots * (n_gu // 128)).data_ptr())
        err = fns[(lib(name), "qmm_moe_m1")](
            xq.data_ptr(), sx.data_ptr(), gq.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            dq.data_ptr(), ds.data_ptr(), db.data_ptr(), yq.data_ptr(), sy.data_ptr(),
            out.data_ptr(), *scratch_args, ei.data_ptr(), 0 if ti is None else ti.data_ptr(),
            topw.data_ptr(), k, dff, nd, sa, sb, slots, st())
        _build.check(err, f"probe_gemv {name}")
        return out

    def int8(name, xq, sx, qs, sc, b):
        m, k = xq.shape
        ns = qs.shape[-1]
        if name == "txn":
            s = Q.txn_split(ns, k, sms)
            part = buf((s, m, ns))
            y = buf((m, ns))
            f = _build.fn("qmm_txn", "qmm_txn", [_build.P] * 8 + [_build.I] * 4 + [_build.P])
            _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(),
                           b.data_ptr(), y.data_ptr(), part.data_ptr(),
                           Q._counter_buf(dev, -(-ns // 128)).data_ptr(), m, k, ns, s, st()),
                         "probe_gemv txn")
            return y
        if name == "parent":
            tiles = -(-ns // 32)
            s = Q.n_split(tiles, k // 64, k // 64 // 8, sms)
        elif name in INT8_SPLITS:
            tiles = -(-ns // 128)
            s = max(1, min(-(-INT8_SPLITS[name] * sms // tiles), k // 64))
        else:
            tiles = -(-ns // 128)
            s = Q.txn_split(ns, k, sms)
        y, part = buf((m, ns)), buf((s, m, ns))
        err = fns[("parent" if name == "parent" else "kernel", "qmm_int8")](
            xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(), y.data_ptr(),
            part.data_ptr(), Q._counter_buf(dev, tiles).data_ptr(), m, k, ns, s, st())
        _build.check(err, f"probe_gemv int8 {name}")
        return y

    def measure(what, names, check, timed, floor, lib_ms, nbytes, ops, layers, tol):
        rec = {"shape": what, "tol": tol, "bitwise_kernel": [], "checked": []}
        first = None
        for name in names:
            if name in DIAGNOSTIC:
                continue
            got, want = check(name)
            again = check(name)[0]
            torch.cuda.synchronize()
            err = rel_err(got, want)
            if not err <= tol:
                raise AssertionError(f"probe_gemv: {name} parts from the plain version at "
                                     f"{what}: {err:.3g} of the largest output")
            if not torch.equal(got, again):
                raise AssertionError(f"probe_gemv: {name} at {what}: a second launch differs")
            rec["checked"].append(name)
            if first is None:
                first = got
            elif torch.equal(got, first):
                rec["bitwise_kernel"].append(name)
        print(f"{what}: within {tol:g} and repeatable: {' '.join(rec['checked'])}; bitwise "
              f"equal to kernel: {' '.join(rec['bitwise_kernel'])}", flush=True)
        if args.check:
            return rec
        timed_names = [n for n in names if n != "read_floor" and (chosen is None or n in chosen)]
        ms = {name: [] for name in timed_names}
        if timed_names:
            C.time_ms(torch, lambda i: timed(timed_names[0], i), layers)  # warm-up, discarded
        for order in (timed_names, timed_names[::-1]):
            for name in order:
                ms[name].append(C.time_ms(torch, lambda i: timed(name, i), layers))
        if floor is not None and "read_floor" in names and (chosen is None
                                                            or "read_floor" in chosen):
            grids = {f"{p}x{t}": C.time_ms(torch, floor(p, t), layers) for p, t in FLOOR_GRIDS}
            best = min(grids, key=grids.get)
            ms["read_floor"] = [grids[best]]
            rec["read_floor_grids"] = grids
            rec["read_floor_best"] = best
        rec["ms"] = ms
        rec["library_ms"] = lib_ms() if lib_ms else None
        bms, by = C.bound_ms(nbytes, ops)
        rec["bound_ms"], rec["bound_by"] = bms, by
        lib_txt = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        print(f"{what}: bound {bms:.4f} ms ({by}), library {lib_txt}", flush=True)
        for name in ms:
            print(f"  {name:18s} " + " ".join(f"{v:.4f}" for v in ms[name]) + " ms  "
                  f"({bms / min(ms[name]):.1%} of bound)", flush=True)
        return rec

    result = {"card": C.nvidia_smi(), "shapes": []}
    if "B" in args.part:
        for label, n, k, layers in M1_SHAPES:
            what = f"qmm_txn_m1 {label} N={n} K={k}"
            qs, sc, b = rand_q4b(gen, layers, n, k, dev)
            x = torch.randn((1, k), generator=gen, device=dev)
            xq, sx = Q.quantize_activations_g32(
                x, 1 + 0.1 * torch.randn(k, generator=gen, device=dev), 1e-5)
            want = Q.qmm_txn_m1_plain(xq, sx, qs[0], sc[0], b[0])
            w = None if args.check else dequant_bf16(torch, qs, sc, b)
            xb = x.to(torch.bfloat16)
            result["shapes"].append(measure(
                what, b_names, lambda name: (gemv(name, xq, sx, qs[0], sc[0], b[0]).clone(), want),
                lambda name, i: gemv(name, xq, sx, qs[i], sc[i], b[i]),
                floor_fn((qs, sc, b)), lambda: C.time_ms(torch, lambda i: torch.matmul(xb, w[i]),
                                                         layers),
                C.q4b_bytes(qs, sc, b) + k + k // 8 + 4 * n, 2 * n * k, layers, 1e-5))
            del qs, sc, b, w, want
            torch.cuda.empty_cache()

        d, dff = 4096, 14336
        layers = 2
        gu, dn = rand_q4b(gen, layers, 2 * dff, d, dev), rand_q4b(gen, layers, d, dff, dev)
        x = torch.randn((1, d), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(
            x, 1 + 0.1 * torch.randn(d, generator=gen, device=dev), 1e-5)
        ids = torch.arange(layers, dtype=torch.int32, device=dev)
        one = torch.ones(1, device=dev)
        want = Q.qmm_moe_m1_plain(xq, sx, *gu, *dn, ids[0:1], None, one)
        nbytes = C.q4b_bytes(*gu) + C.q4b_bytes(*dn) + d + d // 8 + 4 * d
        result["shapes"].append(measure(
            f"qmm_moe_m1 dense FFN d={d} d_ff={dff}", [v for v in b_names if v != "read_floor"],
            lambda name: (moe(name, xq, sx, gu, dn, ids[0:1], None, one).clone(), want),
            lambda name, i: moe(name, xq, sx, gu, dn, ids[i:i + 1], None, one),
            None, None, nbytes, 2 * 3 * dff * d, layers, 2e-3))
        del gu, dn
        torch.cuda.empty_cache()

        E = C.MOE_E
        gu, dn = rand_q4b(gen, E, 2 * dff, d, dev), rand_q4b(gen, E, d, dff, dev)
        pairs = [torch.tensor(p, dtype=torch.int32, device=dev)
                 for p in ((0, 1), (2, 3), (4, 5), (6, 7))]
        ti = torch.zeros(2, dtype=torch.int32, device=dev)
        topw = torch.tensor([0.6, 0.4], device=dev)
        want = Q.qmm_moe_m1_plain(xq, sx, *gu, *dn, pairs[0], ti, topw)
        gu_e, dn_e = C.q4b_bytes(*gu), C.q4b_bytes(*dn)
        result["shapes"].append(measure(
            f"qmm_moe_m1 routed S=2 of E={E}", [v for v in b_names if v != "read_floor"],
            lambda name: (moe(name, xq, sx, gu, dn, pairs[0], ti, topw).clone(), want),
            lambda name, i: moe(name, xq, sx, gu, dn, pairs[i], ti, topw),
            None, None, 2 * (gu_e + dn_e) + d + d // 8 + 8 * d, 2 * 2 * 3 * dff * d, 4, 2e-3))
        for label, (qs, sc, b), k, ebytes in (("gate_up", gu, d, gu_e), ("down", dn, dff, dn_e)):
            n = qs.shape[-1]
            xr = torch.randn((1, k), generator=gen, device=dev)
            rq, rs = Q.quantize_activations_g32(xr)
            want = Q.qmm_txn_m1_r_plain(rq, rs, qs, sc, b, pairs[0], ti)
            w_all = None if args.check else dequant_bf16(torch, qs, sc, b)
            w2 = None if args.check else [w_all.index_select(0, p) for p in pairs]
            xb = xr.to(torch.bfloat16).expand(2, 1, k).contiguous()
            result["shapes"].append(measure(
                f"qmm_txn_m1_r {label} S=2 of E={E} N={n} K={k}",
                [v for v in b_names if v != "read_floor"],
                lambda name: (gemv(name, rq, rs, qs, sc, b, ei=pairs[0], ti=ti).clone(), want),
                lambda name, i: gemv(name, rq, rs, qs, sc, b, ei=pairs[i], ti=ti),
                None, lambda: C.time_ms(torch, lambda i: torch.bmm(xb, w2[i]), 4),
                2 * ebytes + k + k // 8 + 8 * n, 2 * 2 * n * k, 4, 1e-5))
            del w_all, w2
            torch.cuda.empty_cache()
        del gu, dn
        torch.cuda.empty_cache()

    if "A" in args.part:
        for m, label, n, k, layers in INT8_SHAPES:
            what = f"qmm_int8 {label} M={m} N={n} K={k}"
            qs, sc, b = rand_q4b(gen, layers, n, k, dev)
            li = layers - 1
            x = torch.randn((m, k), generator=gen, device=dev)
            xq, sx = Q.quantize_activations_g32(x)
            want = Q.qmm_int8_plain(xq, sx, qs[li], sc[li])
            w = None if args.check else dequant_bf16(torch, qs, sc, b)
            xb = x.to(torch.bfloat16)

            def check(name):
                if name == "txn":
                    return (int8(name, xq, sx, qs[li], sc[li], b[li]).clone(),
                            Q.qmm_txn_plain(xq, sx, qs[li], sc[li], b[li]))
                return int8(name, xq, sx, qs[li], sc[li], b[li]).clone(), want
            result["shapes"].append(measure(
                what, a_names, check, lambda name, i: int8(name, xq, sx, qs[i], sc[i], b[i]),
                None, lambda: C.time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers),
                qs[0].numel() + sc[0].numel() * 2 + m * (k + k // 8) + 4 * m * n,
                2 * m * n * k, layers, 1e-5))
            del qs, sc, b, w, want
            torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
