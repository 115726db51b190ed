#!/usr/bin/env python3
"""Device times of flash_decode_write's design variants, and of the kernel
the cluster split replaced, side by side on one card.

    python3 scripts/probe_fdw.py [--parent DIR]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Every variant is built with nvcc (in parallel) under
llamafile_tpu_torch/build/probe_fdw/, checked against
flash_decode_write_plain at each shape (within 2e-2 of the largest output,
the written K/V rows equal), then timed as chip_smoke.py times a kernel:
one launch on each layer of a 32-layer cache, captured into a CUDA graph,
the median of the replays. Each variant is timed twice at each shape, in
the order below and then in reverse; both readings are printed, beside
sdpa's on the same K/V. Shapes: llama3-8b widths (Hq 32, Hkv 8, D 128) at
B = 1, pos 64 / s_eff 256 (chip_smoke.py phase 4's decode), pos 700 /
s_eff 1024 and pos 1900 / s_eff 2048.

Variants:
  kernel       csrc/flash_decode_write.cu as the port builds it (clusters of
               8; per-warp rings, tensor-core slabs, st.async merge, expf)
  fast_exp     the same with p and the slab's rescale by __expf
  block_ring   the same with a block barrier at every ring stage (a
               block-wide ring of 3 stages of 64 rows)
  pull/8, /16  scripts/fdw_variants/pull.cu: tensor-core tiles, a block-wide
               ring, rank 0 pulling every partial between two cluster
               barriers, at clusters of 8 and 16
  sketch/8,/16 scripts/fdw_variants/sketch.cu: the same merge and ring over
               per-row scalar dots, at clusters of 8 and 16
  parent       with --parent DIR: DIR/llamafile_tpu_torch/csrc/
               flash_decode_write.cu, the kernel of an unpacked checkout
               from before the cluster split (one block per (batch row, kv
               head)), which has the same C entry as `kernel`

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

SHAPES = ((64, 256), (700, 1024), (1900, 2048))
TOL = 2e-2

# block_ring: every warp waits at a block barrier for the stage of its
# slowest sibling, as a block-wide ring does
BLOCK_RING = [
    ("  for (int k = 0; k < nk; ++k) {",
     "  for (int k = 0; k < (n_slabs + NW - 1) / NW; ++k) {"),
    ("    __syncwarp();                      // and every lane's", "    __syncthreads();"),
    ("    attend_slab(ring", "    if (k < nk) attend_slab(ring"),
    ("    __syncwarp();                      // the slot is free again", "    __syncthreads();"),
]
FAST_EXP = [
    ("    corr[j] = expf(", "    corr[j] = __expf("),
    ("    pr[j] = v0 ? expf(", "    pr[j] = v0 ? __expf("),
    ("    pr[j + 2] = v1 ? expf(", "    pr[j + 2] = v1 ? __expf("),
]


def variant_sources(parent):
    """name -> (source text, include dir, takes a cluster size)."""
    from llamafile_tpu_torch.ops import _build
    read = lambda p: open(p).read()
    kernel = read(os.path.join(_build.CSRC, "flash_decode_write.cu"))
    patched = lambda subs: probe_build.patched(kernel, subs, "flash_decode_write.cu")

    out = {"kernel": (kernel, _build.CSRC, False),
           "fast_exp": (patched(FAST_EXP), _build.CSRC, False),
           "block_ring": (patched(BLOCK_RING), _build.CSRC, False)}
    for name in ("pull", "sketch"):
        out[name] = (read(os.path.join(ROOT, "scripts", "fdw_variants", f"{name}.cu")),
                     _build.CSRC, True)
    if parent:
        csrc = os.path.join(parent, "llamafile_tpu_torch", "csrc")
        out["parent"] = (read(os.path.join(csrc, "flash_decode_write.cu")), csrc, False)
    return out


def build(sources):
    """Compile every variant at once; name -> ctypes entry."""
    from llamafile_tpu_torch.ops import _build
    d = os.path.join(_build.BUILD, "probe_fdw")
    os.makedirs(d, exist_ok=True)
    jobs = {}
    for name, (text, inc, _) in sources.items():
        cu = os.path.join(d, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (cu, inc)
    libs = probe_build.build(jobs, d)
    return {name: probe_build.entry(
        lib, "flash_decode_write",
        [_build.P] * 7 + [_build.I] * (7 if sources[name][2] else 6) + [_build.F, _build.P])
        for name, lib in libs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose flash_decode_write.cu "
                                     "is timed as `parent`")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import _build
    from llamafile_tpu_torch.testing import rel_err

    if not torch.cuda.is_available():
        raise SystemExit("probe_fdw: no CUDA device")
    print(C.nvidia_smi(), flush=True)
    sources = variant_sources(args.parent)
    fns = build(sources)
    runs = []                                  # (label, entry, cluster size or None)
    for name in sources:
        for cs in ((8, 16) if sources[name][2] else (None,)):
            runs.append((name if cs is None else f"{name}/{cs}", fns[name], cs))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nl, s_len, hq, hkv, hd = 32, 2048, 32, 8, 128
    scale = hd ** -0.5
    k3 = torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev).to(torch.bfloat16)
    v3 = torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    kn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    vn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    out = torch.empty((1, hq, hd), device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call(f, cs, k, v, li, p, s_eff):
        st = torch.cuda.current_stream().cuda_stream
        extra = () if cs is None else (cs,)
        _build.check(f(q.data_ptr(), k.data_ptr(), v.data_ptr(), kn.data_ptr(),
                       vn.data_ptr(), p.data_ptr(), out.data_ptr(), li, 1, s_len, hq,
                       hkv, s_eff, *extra, scale, st), "probe_fdw")
        return out

    result = {}
    for pos, s_eff in SHAPES:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        kw, vw = k3.clone(), v3.clone()
        want = A.flash_decode_write_plain(q, kw, vw, kn, vn, 5, p, scale, hkv, s_eff)
        errs = {}
        for label, f, cs in runs:
            kc, vc = k3.clone(), v3.clone()
            got = call(f, cs, kc, vc, 5, p, s_eff).clone()
            torch.cuda.synchronize()
            if not (rel_err(got, want) <= TOL and torch.equal(kc, kw) and torch.equal(vc, vw)):
                raise AssertionError(f"probe_fdw: {label} disagrees with the plain "
                                     f"version at pos {pos}")
            errs[label] = (got - want).abs().max().item()
            del kc, vc
        del kw, vw
        ms = {label: [] for label, _, _ in runs}
        for order in (runs, runs[::-1]):
            for label, f, cs in order:
                ms[label].append(C.time_ms(
                    torch, lambda i: call(f, cs, k3, v3, i, p, s_eff), nl))
        qs4 = q.to(torch.bfloat16).reshape(1, hq, 1, hd)
        kv = lambda t, i: t[i, :, :pos + 1].reshape(1, pos + 1, hkv, hd).transpose(1, 2)
        lib = C.time_ms(torch, lambda i: sdpa(qs4, kv(k3, i), kv(v3, i), scale=scale,
                                              enable_gqa=True), nl)
        print(f"pos {pos} / s_eff {s_eff}: sdpa {lib:.4f} ms", flush=True)
        for label, _, _ in runs:
            a, b = ms[label]
            print(f"  {label:12s} {a:.4f} {b:.4f} ms  (max_abs_err {errs[label]:.3g})",
                  flush=True)
        result[f"pos{pos}"] = {"s_eff": s_eff, "sdpa_ms": lib, "ms": ms,
                               "max_abs_err": errs}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
