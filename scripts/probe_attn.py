#!/usr/bin/env python3
"""Device times of the attention kernels (csrc/paged_attention.cu,
flash_prefill.cu, flash_decode.cu, flash_decode_write.cu) beside those of
an older checkout's, sdpa and the bound, on one card.

    python3 scripts/probe_attn.py --parent DIR [--kernels paged_attention,...]
                                  [--shapes 32/8/128,...] [--only kernel,parent,...]
                                  [--check] [--sass DIR] [--fused-ab] [--decode-ab]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The kernel sources of DIR/llamafile_tpu_torch/csrc/ (an unpacked
checkout, built with its own headers) are built with nvcc, all at once,
under llamafile_tpu_torch/build/probe_attn/, beside the design variants
of this tree's kernels (VARIANTS: text patches of a source or of a shared
header); this tree's kernels are built by the port. Each wrapper of
ops.attention is timed with its C entry pointing at this tree's library and
then at the older one's, through an adapter where the C entries differ
(the older paged_attention takes its split and scratch, which the adapter
computes and allocates as that checkout's wrapper did). At each shape
every output is checked against the plain version (chip_smoke.py's
tolerances), then timed as chip_smoke.py times a kernel (a run of launches
over 32 layers of K/V, or over sets of prompt tensors, captured into a
CUDA graph, the median of 25 replays) in the order kernel, rival, rival,
kernel for each rival (the parent, then each variant the shape takes), and
beside sdpa and the bound (chip_smoke.py's yardsticks: bytes over 3.35
TB/s, or f32 flops over 67 TFLOP/s for the decode kernels and bf16 flops
over 989 TFLOP/s for the prefill).

The shapes: paged_attention at PAGED (8 rows of length 1024 at head groups
of 3, 4 and 16, bf16 and int8; 8 rows of lengths 1..2048; phase 8's 4
served rows; D = 256 at Gemma-2-9B's 16 over 8 and Gemma-2B's 8 over 1);
flash_prefill at PREFILL (T = 512, 1024 and 2048 at llama3-8b's 32 over 8,
D = 64 at TinyLlama's 32 over 4, D = 256 at Gemma-2B's 8 over 1 and
Gemma-2-9B's 16 over 8); flash_decode_write and flash_decode at phase 2's
positions for each --shapes hq/hkv/d, and with gemma2's options at
chip_smoke.py's GEMMA_HEADS and GEMMA_POS (option_cases: flash_decode_write
with the window of 4096 and the softcap of 50, flash_decode with the softcap,
then the softcap and the window, bf16 flat and int8, over a cache of 8192
positions), where the parent, which has no softcap (and no window in
flash_decode_write), runs the same call without the options (each rival
is then checked against the plain version without them), and so does
the kernel ("bare").

--check builds and checks only; --only times a subset of the rivals;
--sass DIR writes each library's SASS (cuobjdump) there and prints the
count of its wgmma (HGMMA) and mma.sync (HMMA) instructions by kernel.
With --fused-ab, chip_smoke.py's fused 8-row serving step then runs under
the profiler with paged_attention's entry at the parent's and at this
tree's (fused_ab: device busy a step and the paged kernels' share); with
--decode-ab, phase 4d's int8-KV decode with flash_decode's entry at the
parent's and at this tree's (decode_ab).

The last line printed is one JSON object of every reading.
"""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_build  # noqa: E402

KERNELS = ("flash_decode_write", "flash_decode", "paged_attention", "flash_prefill")
NL = 32
SHAPES = "32/8/128,128/8/128"
SERVED = [56, 160, 532, 1032]          # phase 8's 4 served rows (SERVE_LENGTHS + 32)
# paged_attention: (hq, hkv, d, label, lengths, int8)
PAGED = [(32, 8, 128, "bf16, every length 1024", [1024] * 8, False),
         (32, 8, 128, "int8, every length 1024", [1024] * 8, True),
         (32, 8, 128, "bf16, lengths 1..2048", [1, 63, 64, 65, 700, 1024, 1500, 2048], False),
         (24, 8, 128, "bf16, every length 1024", [1024] * 8, False),
         (24, 8, 128, "int8, every length 1024", [1024] * 8, True),
         (24, 8, 128, "bf16, phase 8's 4 served rows", SERVED, False),
         (128, 8, 128, "bf16, every length 1024", [1024] * 8, False),
         (128, 8, 128, "int8, every length 1024", [1024] * 8, True),
         (16, 8, 256, "bf16, every length 1024", [1024] * 8, False),
         (16, 8, 256, "int8, every length 1024", [1024] * 8, True),
         (8, 1, 256, "bf16, every length 1024", [1024] * 8, False)]
# flash_prefill: (hq, hkv, d, t, prompt sets cycled in a timed run)
PREFILL = [(32, 8, 128, 512, 4), (32, 8, 128, 1024, 2), (32, 8, 128, 2048, 2),
           (32, 4, 64, 1024, 2), (8, 1, 256, 1024, 4), (16, 8, 256, 1024, 2)]
# design variants of this tree's kernels: (kernel, {file of csrc: text
# patches}, the shapes (label, D, G) it is timed at)
VARIANTS = {
    # paged_attention with two slabs in flight a warp for bf16 pages at D = 128
    "pa_ns2": ("paged_attention", {"paged_attention.cu": [(
        "NS = sizeof(T) == 1 && D == 128 ? 2 : 1;", "NS = D == 128 ? 2 : 1;")]},
        lambda label, d, g: d == 128),
    # paged_attention with 8 warps a block
    "pa_nw8": ("paged_attention", {"paged_attention.cu": [(
        "static constexpr int NW = 4; ", "static constexpr int NW = 8; ")]},
        lambda label, d, g: d == 128),
    # paged_attention with 2 warps a block (a third of the shared memory: more
    # blocks an SM)
    "pa_nw2": ("paged_attention", {"paged_attention.cu": [(
        "static constexpr int NW = 4; ", "static constexpr int NW = 2; ")]},
        lambda label, d, g: d == 128),
    # the same with two slabs in flight a warp
    "pa_nw2_ns2": ("paged_attention", {"paged_attention.cu": [
        ("static constexpr int NW = 4; ", "static constexpr int NW = 2; "),
        ("NS = sizeof(T) == 1 && D == 128 ? 2 : 1;", "NS = 2;")]},
        lambda label, d, g: d == 128),
    # paged_attention on clusters of 4 blocks (half the blocks, twice the keys a rank)
    "pa_cs4": ("paged_attention", {"decode_cluster.cuh": [(
        "constexpr int CS = 8; ", "constexpr int CS = 4; ")]},
        lambda label, d, g: d == 128),
    # flash_prefill with one warpgroup a block (64-row query tiles) at D = 128
    "fp_1wg": ("flash_prefill", {"flash_prefill.cu": [(
        "NWG = D == 128 ? 2 : 1;", "NWG = 1;")]},
        lambda label, d, g: d == 128),
    # flash_prefill with a 3-stage K/V ring (copies two tiles ahead)
    "fp_s3": ("flash_prefill", {"flash_prefill.cu": [(
        "static constexpr int STAGES = 2;", "static constexpr int STAGES = 3;")]},
        lambda label, d, g: True),
    # flash_prefill's softmax with the accurate exp2f, not ex2.approx
    "fp_exp2f": ("flash_prefill", {"flash_prefill.cu": [(
        'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")]},
        lambda label, d, g: d == 128),
    # flash_decode_write with three slabs in flight a warp at D = 256
    "fdw_ns3": ("flash_decode_write", {"flash_decode_write.cu": [(
        "fdw_slabs = D == 128 ? 3 : 2;", "fdw_slabs = 3;")]},
        lambda label, d, g: d == 256),
    # flash_decode's int8 form with 4 warps a block (three slabs each) at D = 128
    "fd_q8_nw4": ("flash_decode", {"flash_decode.cu": [
        ("q8_warps(int D) { return D == 128 ? 8 : 4; }", "q8_warps(int D) { return 4; }"),
        ("q8_slabs(int D) { return 2; }", "q8_slabs(int D) { return D == 128 ? 3 : 2; }")]},
        lambda label, d, g: d == 128 and label.startswith("int8")),
    # flash_decode's int8 codes converted by cvt, not by prmt and add
    "fd_q8_cvt": ("flash_decode", {"decode_cluster.cuh": [(
        "f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;",
        "f[i] = (float)(signed char)(w >> (8 * i));")]},
        lambda label, d, g: label.startswith("int8")),
    # flash_decode with chunks of up to 8 heads (one n tile)
    "fd_most8": ("flash_decode", {"flash_decode.cu": [(
        "const int nc = (G + 15) / 16,", "const int nc = (G + 7) / 8,")]},
        lambda label, d, g: g > 8),
}


def paged_cases(torch, dev, gen):
    """(kernel, (hq, hkv, d), label, fn(i) on layer i, plain(i), tolerance,
    error fn, sdpa(i), (bytes, ops, op rate), cycle) of paged_attention, one
    shape's inputs alive at a time."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import paged_case, row_rel_err
    import chip_smoke as C
    for hq, hkv, hd, label, lengths, int8 in PAGED:
        q, kp, vp, ks, vs, lens, tables = paged_case(
            gen, lengths, hq, hkv, hd, 64, 2048 // 64, n_layers=NL, int8=int8, device=dev)
        sc = (lambda t, i: None) if ks is None else (lambda t, i: t[i])
        lay = (lambda i, q=q, kp=kp, vp=vp, ks=ks, vs=vs, lens=lens, tables=tables, sc=sc:
               (q, kp[i], vp[i], lens, tables, sc(ks, i), sc(vs, i)))
        lib = C.paged_yardstick(torch, q, kp, vp, ks, vs, lens, tables, NL)
        chunks = A.head_chunks(hq // hkv, A.PA_CHUNK_HEADS)
        yield ("paged_attention", (hq, hkv, hd),
               label + ("" if chunks == 1 else f", {chunks} chunks"),
               lambda i, lay=lay: A.paged_attention(*lay(i)),
               lambda i, lay=lay: A.paged_attention_plain(*lay(i)), C.PAGED_ROW_TOL,
               row_rel_err, lib, C.paged_work(lengths, hq, hkv, hd, int8), NL)


def prefill_cases(torch, dev, gen):
    """The same for flash_prefill at PREFILL."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    import chip_smoke as C
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for hq, hkv, hd, t, sets in PREFILL:
        qkv = [[torch.randn((1, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
                for h in (hq, hkv, hkv)] for _ in range(sets)]
        heads = [[a.transpose(1, 2) for a in trio] for trio in qkv]
        scale = hd ** -0.5
        yield ("flash_prefill", (hq, hkv, hd), f"T={t}",
               lambda i, qkv=qkv, s=scale: A.flash_prefill(*qkv[i], s),
               lambda i, qkv=qkv, s=scale: A.flash_prefill_plain(*qkv[i], s),
               C.FLASH_ROW_TOL, row_rel_err,
               lambda i, heads=heads, s=scale: sdpa(*heads[i], is_causal=True, scale=s,
                                                    enable_gqa=True),
               C.prefill_work(t, hq, hkv, hd), sets)


def decode_cases(torch, dev, gen, hq, hkv, hd, kernels):
    """The same for flash_decode_write (pos 700 / s_eff 1024, 1900 / 2048,
    64 / 256) and flash_decode (bf16 flat and int8, s_eff 1024 and 2048,
    pos s_eff - 5) at hq query heads over hkv of head dim hd."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import rel_err, row_rel_err
    import chip_smoke as C
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = hd ** -0.5
    out = []
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    if "flash_decode_write" in kernels:
        k3, v3 = ((torch.randn((NL, 1, 2048, hkv * hd), generator=gen, device=dev)
                   ).to(torch.bfloat16) for _ in range(2))
        kn, vn = (torch.randn((1, hkv, hd), generator=gen, device=dev) for _ in range(2))
        for pos, s_eff in ((700, 1024), (1900, 2048), (64, 256)):
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            out.append(("flash_decode_write", (hq, hkv, hd), f"pos={pos} s_eff={s_eff}",
                        lambda i, p=p, s=s_eff: A.flash_decode_write_stacked(
                            q, k3, v3, kn, vn, i, p, scale, hkv, s_limit=s),
                        lambda i, p=p, s=s_eff: A.flash_decode_write_plain(
                            q, k3.clone(), v3.clone(), kn, vn, i, p, scale, hkv, s),
                        2e-2, rel_err, None, None, NL))
    for int8 in (False, True) if "flash_decode" in kernels else ():
        for s_eff in (1024, 2048):
            pos = s_eff - 5
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            if int8:
                kc, vc = (torch.randint(-127, 128, (NL, 1, s_eff, hkv, hd), generator=gen,
                                        device=dev, dtype=torch.int8) for _ in range(2))
                ksc, vsc = (torch.empty((NL, 1, s_eff, hkv), device=dev).uniform_(
                    2e-3, 2e-2, generator=gen) for _ in range(2))
                run = (lambda i, kc=kc, vc=vc, ksc=ksc, vsc=vsc, p=p: A.flash_decode(
                    q, kc[i], vc[i], p, scale, k_scale=ksc[i], v_scale=vsc[i]))
                plain = (lambda i, kc=kc, vc=vc, ksc=ksc, vsc=vsc, p=p: A.flash_decode_plain(
                    q, kc[i], vc[i], p, scale, k_scale=ksc[i], v_scale=vsc[i]))
                dense = [(kc[i, 0, :pos + 1].float() * ksc[i, 0, :pos + 1][..., None],
                          vc[i, 0, :pos + 1].float() * vsc[i, 0, :pos + 1][..., None])
                         for i in range(NL)]
                qd = q.reshape(1, hq, 1, hd)
                nbytes = 2 * (pos + 1) * hkv * (hd + 4)
            else:
                kc, vc = ((torch.randn((NL, 1, s_eff, hkv * hd), generator=gen, device=dev)
                           ).to(torch.bfloat16) for _ in range(2))
                run = (lambda i, kc=kc, vc=vc, p=p: A.flash_decode_stacked(
                    q, kc, vc, i, p, scale, hkv))
                plain = (lambda i, kc=kc, vc=vc, p=p, s=s_eff: A.flash_decode_stacked_plain(
                    q, kc, vc, i, p, scale, hkv, s))
                dense = [(kc[i, 0, :pos + 1].reshape(pos + 1, hkv, hd),
                          vc[i, 0, :pos + 1].reshape(pos + 1, hkv, hd)) for i in range(NL)]
                qd = q.to(torch.bfloat16).reshape(1, hq, 1, hd)
                nbytes = 2 * (pos + 1) * hkv * hd * 2
            dense = [(a.transpose(0, 1)[None].contiguous(), b.transpose(0, 1)[None].contiguous())
                     for a, b in dense]
            lib = (lambda i, dense=dense, qd=qd: sdpa(qd, dense[i][0], dense[i][1], scale=scale,
                                                       enable_gqa=True))
            out.append(("flash_decode", (hq, hkv, hd),
                        f"{'int8' if int8 else 'bf16 flat'} s_eff={s_eff}",
                        run, plain, C.DECODE_INT8_ROW_TOL if int8 else C.DECODE_BF16_ROW_TOL,
                        row_rel_err, lib,
                        (nbytes + 2 * hq * hd * 4 + 4, 4 * (pos + 1) * hq * hd, C.F32_FLOP_PER_S),
                        NL))
    return out


def option_cases(torch, dev, gen, kernels):
    """The same for gemma2's options (chip_smoke.py gemma_option_cases: 8
    layers of a GEMMA_S cache at GEMMA_HEADS and GEMMA_POS). Each case also
    carries the call without the options and its plain version: the parent,
    which has no softcap (and flash_decode_write no window), and the kernel
    "bare" make that call."""
    import chip_smoke as C
    hq, hkv, hd = C.GEMMA_HEADS
    return [(kernel, (hq, hkv, hd), label, lambda i, run=run: run(i, True),
             lambda i, plain=plain: plain(i, True), tol, err_fn, None, work, 8,
             (lambda i, run=run: run(i, False), lambda i, plain=plain: plain(i, False)))
            for kernel, label, run, plain, tol, err_fn, work, _lib in C.gemma_option_cases(
                torch, dev, gen) if kernel in kernels]


def parent_adapter(kernel, old, own_types):
    """A callable with this tree's C signature of `kernel` that launches the
    older checkout's entry `old`: paged_attention's older entry takes its
    split and f32 scratch, which are computed and allocated here as its
    wrapper did (ops/attention.py of that checkout), host work and all;
    flash_decode_write's older entry takes no window and no softcap, and
    flash_decode's no softcap: those are left out of the call (the option
    cases give the parent the call without them);
    the other entries are this tree's."""
    import ctypes
    import torch
    from llamafile_tpu_torch.ops.attention import head_chunks
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "flash_decode_write":
        f = probe_build.entry(old, kernel, own_types[:14] + [F, P])
        return lambda *a: f(*a[:14], a[15], a[17])
    if kernel == "flash_decode":
        f = probe_build.entry(old, kernel, own_types[:16] + [F, P])
        return lambda *a: f(*a[:17], a[18])
    if kernel != "paged_attention":
        return probe_build.entry(old, kernel, own_types)
    f = probe_build.entry(old, kernel, [P] * 11 + [I] * 10 + [P])

    def call(q, k, v, ks, vs, lengths, tables, out, r, hq, hkv, d, n_pages, ps, maxp, int8,
             st):
        dev = torch.device("cuda", torch.cuda.current_device())
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = min(maxp, max(1, -(-4 * sms // (r * hkv * head_chunks(hq // hkv)))))
        pps = -(-maxp // n_split)
        n_split = -(-maxp // pps)
        m_part = torch.empty((r, hq, n_split), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((r, hq, n_split, d), dtype=torch.float32, device=dev)
        call.scratch = (m_part, l_part, acc_part)           # alive until the next call
        return f(q, k, v, ks, vs, lengths, tables, out, m_part.data_ptr(), l_part.data_ptr(),
                 acc_part.data_ptr(), r, hq, hkv, d, n_pages, ps, maxp, pps, n_split, int8, st)
    return call


def dump_sass(libs, out_dir):
    """Each library's SASS into out_dir; prints its HGMMA (wgmma) and HMMA
    (mma.sync) counts by kernel function."""
    from llamafile_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    counts = {}
    for key, path in libs.items():
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                              check=True).stdout
        with open(os.path.join(out_dir, f"{key}.sass".replace("/", "-")), "w") as f:
            f.write(sass)
        fn, per = None, {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per[fn] = [0, 0]
            elif fn is not None:
                per[fn][0] += "HGMMA" in line
                per[fn][1] += bool(re.search(r"\bHMMA\b", line))
        counts[key] = {k: {"HGMMA": a, "HMMA": b} for k, (a, b) in per.items()}
        tot = [sum(v[i] for v in per.values()) for i in (0, 1)]
        print(f"[sass {key}] {len(per)} kernels, HGMMA {tot[0]}, HMMA {tot[1]}", flush=True)
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked checkout whose kernels "
                                                    "are timed as `parent`")
    ap.add_argument("--kernels", default="paged_attention,flash_prefill",
                    help=f"comma-separated, of {','.join(KERNELS)}")
    ap.add_argument("--shapes", default=SHAPES,
                    help="hq/hkv/d of flash_decode_write and flash_decode, comma-separated "
                         "(empty: gemma2's option cases alone)")
    ap.add_argument("--only", default="", help="time only these rivals (kernel always)")
    ap.add_argument("--check", action="store_true", help="build and check only")
    ap.add_argument("--sass", default="", help="write each library's SASS into this directory")
    ap.add_argument("--fused-ab", action="store_true",
                    help="then chip_smoke.py's fused 8-row serving step (llama3-8b Q4_K, "
                         "phase 5's lengths) under torch.profiler with paged_attention's "
                         "entry at the parent's and at this tree's, in the order parent, "
                         "kernel, kernel, parent")
    ap.add_argument("--decode-ab", action="store_true",
                    help="then chip_smoke.py phase 4d's int8-KV decode (llama3-8b Q4_K, "
                         "64 tokens) with flash_decode's entry at the parent's and at this "
                         "tree's, in the order parent, kernel, kernel, parent")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("probe_attn: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    kernels = args.kernels.split(",")
    only = set(args.only.split(",")) - {""}
    _build.build_all(kernels)
    csrc = os.path.join(args.parent, "llamafile_tpu_torch", "csrc")
    base = os.path.join(_build.BUILD, "probe_attn")
    # this tree's kernels again (for ptxas's notes and the SASS), and the parent's
    jobs = {f"{who}/{k}": (os.path.join(d, f"{k}.cu"), d) for k in kernels
            for who, d in (("kernel", _build.CSRC), ("parent", csrc))}
    for name, (kernel, files, _) in VARIANTS.items():
        if kernel not in kernels or (only and name not in only):
            continue
        texts = {f: probe_build.patched(open(os.path.join(_build.CSRC, f)).read(), subs, name)
                 for f, subs in files.items()}
        if f"{kernel}.cu" not in texts:
            texts[f"{kernel}.cu"] = open(os.path.join(_build.CSRC, f"{kernel}.cu")).read()
        d = probe_build.variant_dir(base, name, [h for h in probe_build.headers(_build.CSRC)
                                                 if os.path.basename(h) not in texts], texts)
        jobs[name] = (os.path.join(d, f"{kernel}.cu"), d)
    libs = probe_build.build(jobs, base)
    result = {"card": C.nvidia_smi(), "shapes": []}
    if args.sass:
        result["sass"] = dump_sass(
            {k: os.path.join(base, f"{k}.so".replace("/", "-")) for k in jobs}, args.sass)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {}                          # kernel -> {"kernel": fn, "parent": fn, variant: fn}

    def use(kernel, which):
        _build._fns[(kernel, kernel)] = fns[kernel][which]

    groups = []
    if "paged_attention" in kernels:
        groups.append(lambda: paged_cases(torch, dev, gen))
    if "flash_prefill" in kernels:
        groups.append(lambda: prefill_cases(torch, dev, gen))
    for shape in filter(None, args.shapes.split(",")) if {
            "flash_decode", "flash_decode_write"} & set(kernels) else ():
        hq, hkv, hd = (int(x) for x in shape.split("/"))
        groups.append(lambda hq=hq, hkv=hkv, hd=hd: decode_cases(torch, dev, gen, hq, hkv, hd,
                                                                  kernels))
    if {"flash_decode", "flash_decode_write"} & set(kernels):
        groups.append(lambda: option_cases(torch, dev, gen, kernels))
    for make in groups:
        for kernel, (hq, hkv, hd), label, run, plain, tol, err_fn, lib, work, cycle, *bare \
                in make():
            # a case with options: its rivals, and the kernel "bare", make the
            # call without them (bare_run), held by the plain version bare_plain
            bare_run, bare_plain = bare[0] if bare else (None, None)
            what = f"{kernel} Hq={hq} Hkv={hkv} D={hd} (G={hq // hkv}) {label}"
            if kernel not in fns:         # the wrapper's first call sets its argtypes
                run(0)
                own = _build._fns[(kernel, kernel)]
                fns[kernel] = {"kernel": own, "parent": parent_adapter(
                    kernel, libs[f"parent/{kernel}"], own.argtypes)}
                for name, (k, _, _) in VARIANTS.items():
                    if k == kernel and name in libs:
                        fns[kernel][name] = probe_build.entry(libs[name], kernel, own.argtypes)
            rivals = [r for r in ["parent"] + [
                name for name, (k, _, takes) in VARIANTS.items()
                if k == kernel and name in libs and takes(label, hd, hq // hkv)]
                if not only or r in only]
            runs = {r: run for r in ["kernel"] + rivals}
            if bare_run is not None:
                rivals = ["parent", "bare"]
                runs.update(parent=bare_run, bare=bare_run)
                fns[kernel]["bare"] = fns[kernel]["kernel"]
            want = plain(0)
            outs = {}
            for which in ["kernel"] + rivals:
                use(kernel, which)
                outs[which] = runs[which](0).clone()
                torch.cuda.synchronize()
                e = err_fn(outs[which], want if which == "kernel" or bare_plain is None
                           else bare_plain(0))
                if not e <= tol:
                    raise AssertionError(f"probe_attn: {which} disagrees with the plain "
                                         f"version at {what}: {e} > {tol}")
            use(kernel, "kernel")
            again = torch.equal(run(0), outs["kernel"])
            rec = {"shape": what, "repeat_bitwise": again, "bitwise_equal": {
                r: torch.equal(outs["kernel"], outs[r]) for r in rivals}}
            if bare_run is not None:       # the kernel without the options against the parent
                rec["bitwise_equal"] = {"bare vs parent": torch.equal(outs["bare"],
                                                                      outs["parent"])}
            line = f"{what}: two launches bitwise {again}"
            if not args.check:
                ms = {which: [] for which in ["kernel"] + rivals}
                for rival in rivals or ["kernel"]:
                    for which in ("kernel", rival, rival, "kernel"):
                        use(kernel, which)
                        ms[which].append(C.time_ms(torch, runs[which], cycle))
                use(kernel, "kernel")
                rec["ms"] = ms
                line += "; kernel " + " ".join(f"{t:.4f}" for t in ms["kernel"]) + " ms"
                for r in rivals:
                    line += f", {r} " + " ".join(f"{t:.4f}" for t in ms[r]) + " ms"
                if lib is not None:
                    rec["sdpa_ms"] = C.time_ms(torch, lib, cycle)
                    line += f"; sdpa {rec['sdpa_ms']:.4f} ms"
                if work is not None:
                    rec["bound_ms"], rec["bound_by"] = C.bound_ms(*work)
                    line += f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            print(line + f"; bitwise equal to the kernel: {rec['bitwise_equal']}", flush=True)
            if not again:
                raise AssertionError(f"probe_attn: two launches differ at {what}")
            result["shapes"].append(rec)
            del want, outs
        torch.cuda.empty_cache()
    if args.fused_ab:
        result["fused_ab"] = fused_ab(torch, dev, use)
    if args.decode_ab:
        result["decode_ab"] = decode_ab(torch, dev, use)
    print(json.dumps(result))


def fused_ab(torch, dev, use):
    """The batcher's fused decode chunk at 8 rows (chip_smoke.py fused_step:
    llama3-8b Q4_K, 32 layers, rows at phase 5's lengths, 8 steps) under
    torch.profiler, with paged_attention's C entry at the parent's and at
    this tree's: device busy ms a step, and the paged attention kernels'
    share of it. The step is host-bound: no rate is read from it."""
    import chip_smoke as C
    from torch.profiler import ProfilerActivity, profile
    from llamafile_tpu_torch.server.batcher import _fused_decode_paged
    eng, _ = C.build_engine(torch, dev, "Q4_K")
    pool, tables, pw, rp, tok, pos = C._fused_setup(torch, eng)
    run = lambda: _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
    out = {"kernel": [], "parent": []}
    for which in ("parent", "kernel", "kernel", "parent"):
        use("paged_attention", which)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by_name, _ = C.device_kernels(prof)
        busy = sum(by_name.values()) / 1e3 / 8
        paged = sum(us for name, us in by_name.items()
                    if re.search(r"\bpa_(kernel|split_kernel|combine_kernel)\b", name)) / 1e3 / 8
        out[which].append({"busy_ms": busy, "paged_ms": paged})
    use("paged_attention", "kernel")
    for which, recs in out.items():
        print(f"fused 8-row step, paged_attention {which}: device busy "
              + ", ".join(f"{r['busy_ms']:.4f}" for r in recs) + " ms a step, of it paged "
              + ", ".join(f"{r['paged_ms']:.4f}" for r in recs) + " ms", flush=True)
    del eng
    torch.cuda.empty_cache()
    return out


def decode_ab(torch, dev, use):
    """Phase 4d's decode (chip_smoke.py: llama3-8b Q4_K, 32 layers, int8 KV,
    64 greedy tokens from a 24-token prompt) with flash_decode's C entry at
    the parent's and at this tree's; decode tok/s of each run."""
    import chip_smoke as C
    from llamafile_tpu_torch.runtime.engine import Engine
    eng, _ = C.build_engine(torch, dev, "Q4_K")
    eng8 = Engine(eng.cfg, eng.params, eng.tokenizer, max_seq_len=2048, kv_dtype="int8",
                  device=dev)
    prompt = [int(t) for t in torch.randint(3, eng.cfg.n_vocab, (24,),
                                            generator=torch.Generator().manual_seed(3))]
    out, toks = {"kernel": [], "parent": []}, {}
    for which in ("parent", "kernel", "kernel", "parent"):
        use("flash_decode", which)
        toks[which], counts, _, dec = C.counted_generate(torch, eng8, prompt, 64)
        if counts["flash_decode"] != 32 * 63:
            raise AssertionError(f"decode_ab: {counts['flash_decode']} flash_decode launches")
        out[which].append(63 / dec)
    use("flash_decode", "kernel")
    print(f"phase 4d decode, int8 KV: kernel {out['kernel'][0]:.2f} {out['kernel'][1]:.2f} "
          f"tok/s, parent {out['parent'][0]:.2f} {out['parent'][1]:.2f} tok/s; the same "
          f"tokens: {toks['kernel'] == toks['parent']}", flush=True)
    return {"tok_s": out, "same_tokens": toks["kernel"] == toks["parent"]}


if __name__ == "__main__":
    main()
