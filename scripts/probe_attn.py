#!/usr/bin/env python3
"""Device times of the three decode attention kernels (csrc/
flash_decode_write.cu, flash_decode.cu, paged_attention.cu) beside those of
an older checkout's, at the head groups both serve, on one card.

    python3 scripts/probe_attn.py --parent DIR [--hq 8,16,32,64]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The three sources of DIR/llamafile_tpu_torch/csrc/ (an unpacked
checkout, built with its own headers) are built with nvcc, all at once,
under llamafile_tpu_torch/build/probe_attn/; this tree's kernels are built
by the port. The C entries of the two checkouts take the same arguments,
so each wrapper of ops.attention is timed with its C entry pointing at one
library and then at the other: both get the same launch arguments from the
same wrapper. At each shape both outputs are checked against the plain
version (chip_smoke.py's tolerances), then timed as chip_smoke.py times a
kernel (a run of launches over the layers of a 32-layer cache, captured
into a CUDA graph, the median of 25 replays) in the order kernel, parent,
parent, kernel. The shapes are phase 2's llama3-8b shapes (8 KV heads, D
128): flash_decode_write at B = 1, pos 700 / s_eff 1024, 1900 / 2048 and
64 / 256; flash_decode over a bf16 flat and an int8 cache of s_eff 1024 and
2048, pos s_eff - 5; paged_attention at 8 rows of length 1024 (bf16 and
int8) and of lengths 1..2048 (bf16); each at every query head count of
--hq (default 8, 16, 32, 64: the groups 1, 2, 4 and 8).

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
NL, HKV, HD = 32, 8, 128


def cases(torch, dev, gen, hq):
    """(kernel, label, fn(i) on layer i, plain(i), tolerance, error fn) at
    phase 2's shapes for hq query heads."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import paged_case, rel_err, row_rel_err
    import chip_smoke as C
    scale = HD ** -0.5
    out = []
    k3, v3 = ((torch.randn((NL, 1, 2048, HKV * HD), generator=gen, device=dev)
               ).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((1, hq, HD), generator=gen, device=dev)
    kn, vn = (torch.randn((1, HKV, HD), generator=gen, device=dev) for _ in range(2))
    for pos, s_eff in ((700, 1024), (1900, 2048), (64, 256)):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        out.append(("flash_decode_write", f"pos={pos} s_eff={s_eff}",
                    lambda i, p=p, s=s_eff: A.flash_decode_write_stacked(
                        q, k3, v3, kn, vn, i, p, scale, HKV, s_limit=s),
                    lambda i, p=p, s=s_eff: A.flash_decode_write_plain(
                        q, k3.clone(), v3.clone(), kn, vn, i, p, scale, HKV, s),
                    2e-2, rel_err))
    for int8 in (False, True):
        for s_eff in (1024, 2048):
            p = torch.tensor([s_eff - 5], dtype=torch.int32, device=dev)
            if int8:
                kc, vc = (torch.randint(-127, 128, (NL, 1, s_eff, HKV, HD), generator=gen,
                                        device=dev, dtype=torch.int8) for _ in range(2))
                ksc, vsc = (torch.empty((NL, 1, s_eff, HKV), device=dev).uniform_(
                    2e-3, 2e-2, generator=gen) for _ in range(2))
                run = (lambda i, kc=kc, vc=vc, ksc=ksc, vsc=vsc, p=p: A.flash_decode(
                    q, kc[i], vc[i], p, scale, k_scale=ksc[i], v_scale=vsc[i]))
                plain = (lambda i, kc=kc, vc=vc, ksc=ksc, vsc=vsc, p=p: A.flash_decode_plain(
                    q, kc[i], vc[i], p, scale, k_scale=ksc[i], v_scale=vsc[i]))
            else:
                kc, vc = ((torch.randn((NL, 1, s_eff, HKV * HD), generator=gen, device=dev)
                           ).to(torch.bfloat16) for _ in range(2))
                run = (lambda i, kc=kc, vc=vc, p=p: A.flash_decode_stacked(
                    q, kc, vc, i, p, scale, HKV))
                plain = (lambda i, kc=kc, vc=vc, p=p, s=s_eff: A.flash_decode_stacked_plain(
                    q, kc, vc, i, p, scale, HKV, s))
            out.append(("flash_decode", f"{'int8' if int8 else 'bf16 flat'} s_eff={s_eff}",
                        run, plain, C.DECODE_INT8_ROW_TOL if int8 else C.DECODE_BF16_ROW_TOL,
                        row_rel_err))
    for label, lengths, int8 in (("bf16, every length 1024", [1024] * 8, False),
                                 ("bf16, lengths 1..2048",
                                  [1, 63, 64, 65, 700, 1024, 1500, 2048], False),
                                 ("int8, every length 1024", [1024] * 8, True)):
        qp, kp, vp, ks, vs, lens, tables = paged_case(
            gen, lengths, hq, HKV, HD, 64, 2048 // 64, n_layers=NL, int8=int8, device=dev)
        sc = (lambda t, i: None) if ks is None else (lambda t, i: t[i])
        lay = (lambda i, qp=qp, kp=kp, vp=vp, ks=ks, vs=vs, lens=lens, tables=tables, sc=sc:
               (qp, kp[i], vp[i], lens, tables, sc(ks, i), sc(vs, i)))
        out.append(("paged_attention", label, lambda i, lay=lay: A.paged_attention(*lay(i)),
                    lambda i, lay=lay: A.paged_attention_plain(*lay(i)), C.PAGED_ROW_TOL,
                    row_rel_err))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked checkout whose decode "
                                                    "kernels are timed as `parent`")
    ap.add_argument("--hq", default="8,16,32,64", help="query head counts over 8 KV heads")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("probe_attn: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    _build.build_all(list(KERNELS))
    csrc = os.path.join(args.parent, "llamafile_tpu_torch", "csrc")
    parent = probe_build.build({k: (os.path.join(csrc, f"{k}.cu"), csrc) for k in KERNELS},
                               os.path.join(_build.BUILD, "probe_attn"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {}                                  # kernel -> {"kernel": fn, "parent": fn}

    def use(kernel, which):
        _build._fns[(kernel, kernel)] = fns[kernel][which]

    result = {"card": C.nvidia_smi(), "shapes": []}
    for hq in (int(h) for h in args.hq.split(",")):
        for kernel, label, run, plain, tol, err_fn in cases(torch, dev, gen, hq):
            what = f"{kernel} Hq={hq} Hkv={HKV} (G={hq // HKV}) {label}"
            want = plain(5)
            outs = {}
            for which in ("kernel", "parent"):
                if kernel not in fns:         # the wrapper's first call sets its argtypes
                    run(5)
                    own = _build._fns[(kernel, kernel)]
                    fns[kernel] = {"kernel": own, "parent": probe_build.entry(
                        parent[kernel], kernel, own.argtypes)}
                use(kernel, which)
                outs[which] = run(5).clone()
                torch.cuda.synchronize()
                e = err_fn(outs[which], want)
                if not e <= tol:
                    raise AssertionError(f"probe_attn: {which} disagrees with the plain "
                                         f"version at {what}: {e} > {tol}")
            ms = {"kernel": [], "parent": []}
            for which in ("kernel", "parent", "parent", "kernel"):
                use(kernel, which)
                ms[which].append(C.time_ms(torch, run, NL))
            use(kernel, "kernel")
            same = torch.equal(outs["kernel"], outs["parent"])
            print(f"{what}: kernel {ms['kernel'][0]:.4f} {ms['kernel'][1]:.4f} ms, parent "
                  f"{ms['parent'][0]:.4f} {ms['parent'][1]:.4f} ms; outputs bitwise equal: "
                  f"{same}", flush=True)
            result["shapes"].append({"shape": what, "ms": ms, "bitwise_equal": same})
            del want, outs
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
