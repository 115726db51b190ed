#!/usr/bin/env python3
"""Device times of the int8 prefill GEMM's design variants (csrc/qmm_i8p.cu),
of the kernel it replaced, and of its yardsticks, side by side on one card.

    python3 scripts/probe_i8p.py [--parent DIR] [--check]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Each variant of csrc/qmm_i8p.cu is built with nvcc, all at once,
under llamafile_tpu_torch/build/probe_i8p/<variant>/, and ptxas's register,
spill and wgmma notes are printed. Every variant is then checked bit for bit
against the plain version (qmm_i8p_plain) at every shape, and the variants
are timed as chip_smoke.py times a kernel (a run of launches cycling over
enough layers of a stack to spill the L2, captured into a CUDA graph, the
median of 25 replays), in the order below and then in reverse, beside
torch._int_mm on the same codes (without the per-block scales) and the
port's qmm_dequant (the bf16 prefill GEMM on Q4_K weights) at the same
shape. The shapes are llama3-8b's four prefill products (qkv, o, gate|up,
down) at M = 128, 512 and 1024, and gate|up at M = 300, on layer i of a
stack (the stacked form's views by pointer). --check builds and checks
only.

Variants:
  kernel    csrc/qmm_i8p.cu as the port builds it (s8 wgmma m64nNk32 from
            128-byte-swizzled shared memory, a 6-stage cp.async ring four
            steps ahead, one s32 accumulator set whose fold waits for all
            of the block's wgmmas (wgmma.wait_group 0); the n tile of
            ops.qmatmul.i8p_tile_n)
  bn128     the kernel at the 128-wide n tile everywhere
  bn64      the kernel at the 64-wide n tile everywhere
  overlap   two s32 sets a warpgroup: block b's wgmmas go into set b % 2,
            and block b - 1 is folded from the other set beside block b's
            first wgmmas, so the fold does not drain the tensor cores
  ring4     a 4-stage ring, loads two steps ahead
  ring5     a 5-stage ring, loads three steps ahead
  guarded   the kernel with a warpgroup whose rows all lie past M skipping
            its wgmmas: ptxas then serializes the wgmmas (warning C7518)
  parent    with --parent DIR: the qmm_i8p.cu of an unpacked checkout
            (DIR/llamafile_tpu_torch/csrc/), built with its own headers

An n tile of 256 is not a variant: a thread would hold 128 f32 and 128 s32
accumulators (with two sets 384), over the 255 registers a thread may have.

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

# overlap: run_block with two sets, the fold of block b - 1 beside block
# b's first step; blocks run in pairs (set 0, set 1) with no branch around
# a wgmma, an odd count's last block after the pairs
OVERLAP_BLOCK = r'''// The STEPS K steps of 256-block b into the s32 set S, and the fold of
// block b - 1 (set S ^ 1) beside this block's first step.
template <int BN, int S>
__device__ __forceinline__ void run_block(const Args& a, int b, float (&acc)[BN / 2],
                                          int (&p)[2][BN / 2]) {
  const int nk = a.K / BK;
  const uint32_t s0 = smem_addr(a.smem);
#pragma unroll
  for (int h = 0; h < STEPS; ++h) {
    const int ks = STEPS * b + h;
    cp_async_wait<DIST - 1>();
    wgmma::fence_proxy_async();
    __syncthreads();
    mma_step<BN>(p[S], s0 + (ks % STAGES) * Stage<BN>::BYTES, a.wg, h == 0);
    if (ks + DIST < nk)
      load_stage<BN>(a.smem + ((ks + DIST) % STAGES) * Stage<BN>::BYTES, a.xq, a.sxa, a.w8,
                     a.sw, ks + DIST, a.m0, a.n0, a.M, a.K, a.Ns);
    cp_async_commit();
    wgmma::wait<1>();                        // block b - 1's wgmmas are done
    if (h == 0 && b > 0) {
      wgmma::fence_operands(p[S ^ 1]);
      fold<BN>(acc, p[S ^ 1], a.smem + ((ks - 1) % STAGES) * Stage<BN>::BYTES, a.wg);
    }
  }
}

'''
OVERLAP_LOOP = r'''  int b = 0;
  for (; b + 1 < nb; b += 2) {
    run_block<BN, 0>(a, b, acc, p);
    run_block<BN, 1>(a, b + 1, acc, p);
  }
  const unsigned char* last = smem + ((nk - 1) % STAGES) * Stage<BN>::BYTES;
  if (b < nb) {
    run_block<BN, 0>(a, b, acc, p);
    wgmma::wait<0>();
    wgmma::fence_operands(p[0]);
    fold<BN>(acc, p[0], last, a.wg);
  } else {
    wgmma::wait<0>();
    wgmma::fence_operands(p[1]);
    fold<BN>(acc, p[1], last, a.wg);
  }
'''

# name -> (the bn argument of the C entry or None for i8p_tile_n's, text
# substitutions of csrc/qmm_i8p.cu as probe_build.patched takes them)
VARIANTS = {
    "kernel": (None, []),
    "bn128": (128, []),
    "bn64": (64, []),
    "overlap": (None, [
        ("// The STEPS K steps of 256-block b", "template <int BN>\n__global__", OVERLAP_BLOCK),
        ("  int p[BN / 2];\n", "  int p[2][BN / 2];\n"),
        ("  for (int b = 0; b < nb; ++b) run_block<BN>(a, b, acc, p);\n", OVERLAP_LOOP)]),
    "ring4": (None, [("constexpr int STAGES = 6;", "constexpr int STAGES = 4;")]),
    "ring5": (None, [("constexpr int STAGES = 6;", "constexpr int STAGES = 5;")]),
    "guarded": (None, [("    mma_step<BN>(p, s0", "    if (a.m0 + 64 * a.wg < a.M) "
                                                "mma_step<BN>(p, s0")]),
}
SHAPES = [(m, label, n, k, layers)
          for m in (1024, 512, 128)
          for label, n, k, layers in (("gate_up", 28672, 4096, 2), ("down", 4096, 14336, 3),
                                      ("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12))]
SHAPES.insert(4, (300, "gate_up", 28672, 4096, 2))


def build(parent):
    """Build every source at once (the bn variants share the kernel's);
    source name -> ctypes fn."""
    from llamafile_tpu_torch.ops import _build
    base = os.path.join(_build.BUILD, "probe_i8p")
    src = open(os.path.join(_build.CSRC, "qmm_i8p.cu")).read()
    jobs = {}
    for name, (_, subs) in VARIANTS.items():
        if name.startswith("bn"):
            continue
        d = probe_build.variant_dir(base, name, probe_build.headers(_build.CSRC),
                                    {"qmm_i8p.cu": probe_build.patched(src, subs, "qmm_i8p.cu")})
        jobs[name] = (os.path.join(d, "qmm_i8p.cu"), d)
    if parent:
        csrc = os.path.join(parent, "llamafile_tpu_torch", "csrc")
        jobs["parent"] = (os.path.join(csrc, "qmm_i8p.cu"), csrc)
    libs = probe_build.build(jobs, os.path.join(base, "lib"))
    return {name: probe_build.entry(
        lib, "qmm_i8p", [_build.P] * 5 + [_build.I] * (3 if name == "parent" else 4) + [_build.P])
        for name, lib in libs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose qmm_i8p.cu is timed as "
                                     "`parent`")
    ap.add_argument("--check", action="store_true", help="build and check only")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import _build
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import i8p_fault, rand_i8p, rand_q4b

    if not torch.cuda.is_available():
        raise SystemExit("probe_i8p: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    fns = build(args.parent)
    names = list(VARIANTS) + (["parent"] if args.parent else [])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    st = lambda: torch.cuda.current_stream().cuda_stream

    def run(name, xq, sxa, w8, sw, y):
        m, k = xq.shape
        ns = w8.shape[0]
        ptrs = (xq.data_ptr(), sxa.data_ptr(), w8.data_ptr(), sw.data_ptr(), y.data_ptr())
        if name == "parent":
            err = fns["parent"](*ptrs, m, k, ns, st())
        else:
            bn = VARIANTS[name][0] or Q.i8p_tile_n(m, ns, sms)
            err = fns["kernel" if name.startswith("bn") else name](*ptrs, m, k, ns, bn, st())
        _build.check(err, f"probe_i8p {name}")
        return y

    result = {"card": C.nvidia_smi(), "shapes": []}
    for m, label, n, k, layers in SHAPES:
        what = f"{label} M={m} N={n} K={k}, layer i of {layers}"
        w8, sw = rand_i8p(gen, layers, n, k, dev)
        xq, sxa = Q.i8p_prep(torch.randn((m, k), generator=gen, device=dev))
        want = Q.qmm_i8p_plain(xq, sxa, w8[1], sw[1])
        bad = i8p_fault(xq, sxa, w8[1], sw[1])
        if torch.equal(bad, want):
            raise AssertionError(f"probe_i8p: the faulty control equals the plain version at "
                                 f"{what}")
        y = torch.empty((m, n), device=dev)
        for name in names:
            got = run(name, xq, sxa, w8[1], sw[1], y).clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got != want).sum().item()
                raise AssertionError(f"probe_i8p: {name} differs from the plain version at "
                                     f"{what} in {diff} elements")
        rec = {"shape": what, "bn": Q.i8p_tile_n(m, n, sms), "bitwise": names}
        if not args.check:
            ms = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    ms[name].append(C.time_ms(
                        torch, lambda i: run(name, xq, sxa, w8[i], sw[i], y), layers))
            rec["ms"] = ms
            wt = [w8[i].t() for i in range(layers)]             # [K, N] views
            rec["int_mm_ms"] = C.time_ms(torch, lambda i: torch._int_mm(xq, wt[i]), layers)
            del wt
            qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            rec["qmm_dequant_ms"] = C.time_ms(
                torch, lambda i: Q.qmm_dequant(xb, qs[i], sc[i]), layers)
            del qs, sc, xb
            bms, _ = C.bound_ms(n * k + (k // 256) * n * 4 + m * k + m * (k // 256) * 4
                                + 4 * m * n, 2 * m * n * k)
            rec["bound_ms"] = bms
            print(f"{what} (auto n tile {rec['bn']}): bound {bms:.4f} ms, torch._int_mm "
                  f"{rec['int_mm_ms']:.4f} ms, qmm_dequant {rec['qmm_dequant_ms']:.4f} ms",
                  flush=True)
            for name in names:
                a, c = ms[name]
                print(f"  {name:8s} {a:.4f} {c:.4f} ms", flush=True)
        else:
            print(f"{what}: every variant bitwise equal to the plain version", flush=True)
        result["shapes"].append(rec)
        del w8, sw, xq, sxa, want, bad, y
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
