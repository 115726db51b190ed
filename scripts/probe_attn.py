#!/usr/bin/env python3
"""Device times of the three decode attention kernels (csrc/
flash_decode_write.cu, flash_decode.cu, paged_attention.cu) beside those of
an older checkout's, and of flash_decode beside sdpa and its bound, on one
card.

    python3 scripts/probe_attn.py --parent DIR [--shapes 32/8/128,...]
                                  [--kernels flash_decode,...]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The three sources of DIR/llamafile_tpu_torch/csrc/ (an unpacked
checkout, built with its own headers) are built with nvcc, all at once,
under llamafile_tpu_torch/build/probe_attn/, beside the design variants
of this tree's kernels (VARIANTS: text patches of the sources); this
tree's kernels are built by the port. Each wrapper of ops.attention is
timed with its C entry pointing at this tree's library and then at the
older one's, through an adapter where the C
entries differ: the older flash_decode_write and paged_attention take no
head dim (D = 128 only), and the older flash_decode takes the split and
its scratch, which the adapter computes and allocates as that checkout's
wrapper did. At each shape both outputs are checked against the plain
version (chip_smoke.py's tolerances), then timed as chip_smoke.py times a
kernel (a run of launches over the layers of a 32-layer cache, captured
into a CUDA graph, the median of 25 replays) in the order kernel, parent,
parent, kernel, then likewise beside each variant that the shape takes
(at D = 256 the older kernels raised: no parent). flash_decode is
also timed beside sdpa on the visible K/V (bf16, or dequantized to f32
beforehand for int8) and its bound (bytes over 3.35 TB/s, or f32 flops
over 67 TFLOP/s).

The shapes (hq/hkv/d, at B = 1): flash_decode_write at pos 700 / s_eff
1024, 1900 / 2048 and 64 / 256; flash_decode over a bf16 flat and an int8
cache of s_eff 1024 and 2048, pos s_eff - 5; paged_attention at 8 rows of
length 1024 (bf16 and int8) and of lengths 1..2048 (bf16). The default
takes groups 1, 2, 3, 4, 8 and 16 over 8 KV heads at D = 128, and at D =
256 Gemma-2-9B's 16 over 8, Gemma-2B's 8 over 1 and the groups 3, 4 and 16
over 8.

With --decode-ab, chip_smoke.py phase 4d's int8-KV decode then runs with
flash_decode's entry at the parent's and at this tree's (decode_ab).

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

KERNELS = ("flash_decode_write", "flash_decode", "paged_attention")
NL = 32
SHAPES = ("8/8/128,16/8/128,24/8/128,32/8/128,64/8/128,128/8/128,"
          "16/8/256,8/1/256,24/8/256,32/8/256,128/8/256")
# design variants of this tree's kernels (text patches of the source), the
# kernel each patches, and the shapes (label, D, G) it is timed at
VARIANTS = {
    # flash_decode_write with three slabs in flight a warp at D = 256
    "fdw_ns3": ("flash_decode_write", [("fdw_slabs = D == 128 ? 3 : 2;", "fdw_slabs = 3;")],
                lambda label, d, g: d == 256),
    # flash_decode's int8 form with 4 warps a block (three slabs each) at D = 128
    "fd_q8_nw4": ("flash_decode", [
        ("q8_warps(int D) { return D == 128 ? 8 : 4; }", "q8_warps(int D) { return 4; }"),
        ("q8_slabs(int D) { return 2; }", "q8_slabs(int D) { return D == 128 ? 3 : 2; }")],
        lambda label, d, g: d == 128 and label.startswith("int8")),
    # flash_decode's int8 codes converted by cvt, not by prmt and add
    "fd_q8_cvt": ("flash_decode", [(
        "f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;",
        "f[i] = (float)(signed char)(w >> (8 * i));")],
        lambda label, d, g: label.startswith("int8")),
    # flash_decode with chunks of up to 8 heads (one n tile)
    "fd_most8": ("flash_decode", [(
        "const int nc = (G + 15) / 16,", "const int nc = (G + 7) / 8,")],
        lambda label, d, g: g > 8),
}


def cases(torch, dev, gen, hq, hkv, hd, kernels):
    """(kernel, label, fn(i) on layer i, plain(i), tolerance, error fn,
    sdpa(i) or None, (bytes, flops) of the bound or None) at phase 2's
    shapes for hq query heads over hkv at head dim hd."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import paged_case, rel_err, row_rel_err
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
            out.append(("flash_decode_write", f"pos={pos} s_eff={s_eff}",
                        lambda i, p=p, s=s_eff: A.flash_decode_write_stacked(
                            q, k3, v3, kn, vn, i, p, scale, hkv, s_limit=s),
                        lambda i, p=p, s=s_eff: A.flash_decode_write_plain(
                            q, k3.clone(), v3.clone(), kn, vn, i, p, scale, hkv, s),
                        2e-2, rel_err, None, None))
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
            out.append(("flash_decode", f"{'int8' if int8 else 'bf16 flat'} s_eff={s_eff}",
                        run, plain, C.DECODE_INT8_ROW_TOL if int8 else C.DECODE_BF16_ROW_TOL,
                        row_rel_err, lib,
                        (nbytes + 2 * hq * hd * 4 + 4, 4 * (pos + 1) * hq * hd)))
    for label, lengths, int8 in (("bf16, every length 1024", [1024] * 8, False),
                                 ("bf16, lengths 1..2048",
                                  [1, 63, 64, 65, 700, 1024, 1500, 2048], False),
                                 ("int8, every length 1024", [1024] * 8, True)):
        if "paged_attention" not in kernels:
            break
        qp, kp, vp, ks, vs, lens, tables = paged_case(
            gen, lengths, hq, hkv, hd, 64, 2048 // 64, n_layers=NL, int8=int8, device=dev)
        sc = (lambda t, i: None) if ks is None else (lambda t, i: t[i])
        lay = (lambda i, qp=qp, kp=kp, vp=vp, ks=ks, vs=vs, lens=lens, tables=tables, sc=sc:
               (qp, kp[i], vp[i], lens, tables, sc(ks, i), sc(vs, i)))
        out.append(("paged_attention", label, lambda i, lay=lay: A.paged_attention(*lay(i)),
                    lambda i, lay=lay: A.paged_attention_plain(*lay(i)), C.PAGED_ROW_TOL,
                    row_rel_err, None, None))
    return out


def parent_adapter(kernel, old):
    """A callable with this tree's C signature of `kernel` that launches the
    older checkout's entry `old` (D = 128 only)."""
    import torch
    if kernel in ("flash_decode_write", "paged_attention"):
        at = 12 if kernel == "flash_decode_write" else 14     # the head dim's place

        def call(*a):
            if a[at] != 128:
                raise ValueError("the parent's kernel takes D = 128 only")
            return old(*a[:at], *a[at + 1:])
        return call
    def call(q, k, v, ks, vs, pos, out, b, hq, hkv, d, s_eff, sb, ssb, win, int8, scale, st):
        # the older wrapper's split (ops/attention.py of the parent) and
        # scratch, with its host work of every call
        if d != 128:
            raise ValueError("the parent's kernel takes D = 128 only")
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
        blocks = b * hkv * -(-(hq // hkv) // 8)
        per_split = -(-s_eff // max(1, -(-4 * sms // blocks)))
        chunk = max(16, -(-per_split // 16) * 16)
        n_split = -(-s_eff // chunk)
        dev = torch.device("cuda", torch.cuda.current_device())
        m_part = torch.empty((b, hq, n_split), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((b, hq, n_split, d), dtype=torch.float32, device=dev)
        call.scratch = (m_part, l_part, acc_part)           # alive until the next call
        return old(q, k, v, ks, vs, pos, out, m_part.data_ptr(), l_part.data_ptr(),
                   acc_part.data_ptr(), b, hq, hkv, s_eff, sb, ssb, win, chunk, n_split,
                   int8, scale, st)
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked checkout whose decode "
                                                    "kernels are timed as `parent`")
    ap.add_argument("--shapes", default=SHAPES, help="hq/hkv/d, comma-separated")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--decode-ab", action="store_true",
                    help="then chip_smoke.py phase 4d's int8-KV decode (llama3-8b Q4_K, "
                         "64 tokens) with flash_decode's entry at the parent's and at this "
                         "tree's, in the order parent, kernel, kernel, parent")
    args = ap.parse_args()
    import ctypes
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("probe_attn: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    kernels = args.kernels.split(",")
    _build.build_all(list(KERNELS))
    csrc = os.path.join(args.parent, "llamafile_tpu_torch", "csrc")
    base = os.path.join(_build.BUILD, "probe_attn")
    jobs = {k: (os.path.join(csrc, f"{k}.cu"), csrc) for k in KERNELS}
    for name, (kernel, subs, _) in VARIANTS.items():
        src = open(os.path.join(_build.CSRC, f"{kernel}.cu")).read()
        d = probe_build.variant_dir(base, name, probe_build.headers(_build.CSRC), {
            f"{kernel}.cu": probe_build.patched(src, subs, name)})
        jobs[name] = (os.path.join(d, f"{kernel}.cu"), d)
    libs = probe_build.build(jobs, base)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {}                          # kernel -> {"kernel": fn, "parent": fn, variant: fn}
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    old_types = {"flash_decode_write": [P] * 7 + [I] * 6 + [F, P],
                 "flash_decode": [P] * 10 + [I] * 4 + [L, L] + [I] * 4 + [F, P],
                 "paged_attention": [P] * 11 + [I] * 9 + [P]}

    def use(kernel, which):
        _build._fns[(kernel, kernel)] = fns[kernel][which]

    result = {"card": C.nvidia_smi(), "shapes": []}
    for shape in args.shapes.split(","):
        hq, hkv, hd = (int(x) for x in shape.split("/"))
        for kernel, label, run, plain, tol, err_fn, lib, work in cases(
                torch, dev, gen, hq, hkv, hd, kernels):
            what = f"{kernel} Hq={hq} Hkv={hkv} D={hd} (G={hq // hkv}) {label}"
            if kernel not in fns:         # the wrapper's first call sets its argtypes
                run(5)
                own = _build._fns[(kernel, kernel)]
                fns[kernel] = {"kernel": own, "parent": parent_adapter(
                    kernel, probe_build.entry(libs[kernel], kernel, old_types[kernel]))}
                for name, (k, _, _) in VARIANTS.items():
                    if k == kernel:
                        fns[kernel][name] = probe_build.entry(libs[name], kernel, own.argtypes)
            rivals = (["parent"] if hd == 128 else []) + [
                name for name, (k, _, takes) in VARIANTS.items()
                if k == kernel and takes(label, hd, hq // hkv)]
            want = plain(5)
            outs = {}
            for which in ["kernel"] + rivals:
                use(kernel, which)
                outs[which] = run(5).clone()
                torch.cuda.synchronize()
                e = err_fn(outs[which], want)
                if not e <= tol:
                    raise AssertionError(f"probe_attn: {which} disagrees with the plain "
                                         f"version at {what}: {e} > {tol}")
            ms = {which: [] for which in ["kernel"] + rivals}
            for rival in rivals or ["kernel"]:
                for which in ("kernel", rival, rival, "kernel"):
                    use(kernel, which)
                    ms[which].append(C.time_ms(torch, run, NL))
            use(kernel, "kernel")
            rec = {"shape": what, "ms": ms, "bitwise_equal": {
                r: torch.equal(outs["kernel"], outs[r]) for r in rivals}}
            line = f"{what}: kernel " + " ".join(f"{t:.4f}" for t in ms["kernel"]) + " ms"
            for r in rivals:
                line += f", {r} " + " ".join(f"{t:.4f}" for t in ms[r]) + " ms"
            if lib is not None:
                rec["sdpa_ms"] = C.time_ms(torch, lib, NL)
                rec["bound_ms"], rec["bound_by"] = C.bound_ms(*work, C.F32_FLOP_PER_S)
                line += (f"; sdpa {rec['sdpa_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                         f"({rec['bound_by']})")
            print(line + f"; bitwise equal to the kernel: {rec['bitwise_equal']}", flush=True)
            result["shapes"].append(rec)
            del want, outs
        torch.cuda.empty_cache()
    if args.decode_ab:
        result["decode_ab"] = decode_ab(torch, dev, use)
    print(json.dumps(result))


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
