#!/usr/bin/env python3
"""Drive llamafile_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

1. Set-up: the card's name and power limit, torch/CUDA/nvcc versions, and a
   parallel build of every CUDA kernel from llamafile_tpu_torch/csrc/.
2. Each kernel at the shapes of the llama3-8b main paths (Q4_K decode and
   prefill, Q8_0 and Q6_K decode, long-prompt prefill), held against its
   plain PyTorch version on the same inputs (the tolerances of the CPU and
   card tests) and timed on the device: a run of launches cycling over
   enough layers of weights to spill the 50 MB L2 (as decode does) is
   captured in a CUDA graph and replayed between CUDA events, median of 25
   replays, so the host's dispatch cost is left out. Timed: the kernel, its
   plain version, one PyTorch library call computing the same function where
   there is one, and the bound (bytes over the card's memory rate, or
   operations over its peak rate, whichever is larger).
3. Whole paths at two layers of llama3-8b width, card (kernels) against the
   same model on the CPU (plain versions): Q4_K with a 32-token prompt and 8
   decode steps, Q4_K with a 300-token prompt (bucket 512) and 2 decode
   steps, Q8_0 with a 24-token prompt (bucket 32) and 4 decode steps. Each
   is traced op by op: for each step, the first product, quantization or
   attention call where card and CPU part, and the largest parting; a
   product whose input codes agree on both sides must agree within 1e-5.
4. The main paths at full width through Engine.generate, each with every
   launch count set to 0 just before it and read just after, and checked
   exactly:
   4. make_synthetic_llama("llama3-8b", Q4_K, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate, time to
      first token and the weight-read bound;
   4b. the same engine, a 1000-token prompt (bucket 1024): time to first
      token through the dequant GEMM and the flash prefill;
   4c. make_synthetic_llama("llama3-8b", Q8_0, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate against its
      weight-read bound, and time to first token.
   Then, after every timed run (so that no profiler session of the process
   precedes a timing), profiles: one 8-step decode chunk of
   each model under torch.profiler (the device's busy share of a step) and
   under cProfile (host time by function), and one 1000-token prefill
   (device time by kernel).

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the lines before it hold the kernel table
(one JSON object with an entry a kernel: the numbers of its first shape, the
main path's heaviest, every measured shape under "shapes", and its launches
summed over the runs of phase 4) and the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
SAMPLES = 25
FLASH_ROW_TOL = 1.5e-2


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, op_rate: float = INT8_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, n_cycle: int, samples: int = SAMPLES) -> float:
    """Device time of one call. n_cycle calls fn(0..n_cycle-1) are captured
    into one CUDA graph, so the host's dispatch cost is left out; the result
    is the median over `samples` replays, timed between two CUDA events,
    divided by n_cycle."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: first launches, allocations
        for i in range(n_cycle):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_cycle):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n_cycle)
    del graph
    return statistics.median(out)


def q4b_bytes(qs, sc, b):
    return sum(t[0].numel() * t.element_size() for t in (qs, sc, b))


def check_close(name, got, want, rel):
    from llamafile_tpu_torch.testing import rel_err
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max_abs_err {err:.6g} (max |ref| {want.float().abs().max().item():.6g}, "
        f"tol {rel} x max)")
    if not rel_err(got, want) <= rel:
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{err} > {rel} x max |ref|")
    return err


def kernel_phases(torch, dev, gen):
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops.repack import q4b_codes
    from llamafile_tpu_torch.testing import (flash_prefill_tile_fault, rand_q4b, rand_q8b,
                                             row_rel_err)
    rows = {}

    def dequant_bf16(qs, sc, b):
        k = qs.shape[-2] * 2
        w = q4b_codes(qs).float().reshape(qs.shape[0], k // 32, 32, -1)
        w = w * sc.float()[:, :, None] + b.float()[:, :, None]
        return w.reshape(qs.shape[0], k, -1).to(torch.bfloat16)

    def entry(name, src, replaces, shape, err, ms, plain, lib, nbytes, ops,
              op_rate=INT8_OPS_PER_S):
        bms, by = bound_ms(nbytes, ops, op_rate)
        meas = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib)
        if name not in rows:     # one entry a kernel: its first shape heads it
            rows[name] = dict(name=name, route="cuda", source=src,
                              replaces=replaces, launches=None, **meas, shapes=[])
        rows[name]["shapes"].append(meas)
        log(f"  {name} [{shape}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib if lib is None else round(lib, 4)} ms, bound "
            f"{bms:.4f} ms ({by}), {bms / ms:.1%} of bound")

    # --- qmm_txn_m1: the decode GEMVs (qkv, o, lm head) ------------------
    for label, n, k, layers in (("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12),
                                ("lm_head", 129024, 4096, 1)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x, nrm, 1e-5)
        got = Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_m1_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_txn_m1/{label}", got, want, 1e-5)
        ms = time_ms(torch, lambda i: Q.qmm_txn_m1(xq, sx, qs[i], sc[i], b[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_txn_m1_plain(xq, sx, qs[i], sc[i], b[i]),
                        layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_txn_m1", "llamafile_tpu_torch/csrc/qmm_txn_m1.cu",
              "llamafile_tpu/ops/qmatmul.py:457", f"{label} M=1 N={n} K={k}",
              err, ms, plain, lib, q4b_bytes(qs, sc, b) + k + k // 8 + 4 * n,
              2 * n * k)
        del qs, sc, b

    # --- qmm_txn: prefill products of a 32- and a 16-token bucket ---------
    # (the main path's 24-token prompt runs all four at M = 32)
    for m, label, n, k, layers in ((32, "gate_up", 28672, 4096, 2),
                                   (32, "down", 4096, 14336, 3),
                                   (32, "qkv", 6144, 4096, 8),
                                   (32, "o", 4096, 4096, 12),
                                   (16, "gate_up", 28672, 4096, 2),
                                   (16, "down", 4096, 14336, 3)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        got = Q.qmm_txn(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_txn/{label}/M={m}", got, want, 1e-5)
        ms = time_ms(torch, lambda i: Q.qmm_txn(xq, sx, qs[i], sc[i], b[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_txn_plain(xq, sx, qs[i], sc[i], b[i]), layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_txn", "llamafile_tpu_torch/csrc/qmm_txn.cu",
              "llamafile_tpu/ops/qmatmul.py:276", f"{label} M={m} N={n} K={k}",
              err, ms, plain, lib,
              q4b_bytes(qs, sc, b) + m * (k + k // 8) + 4 * m * n, 2 * m * n * k)
        del qs, sc, b

    # --- qmm_dequant: the prefill GEMM (q4b M > 32, q8b M >= 2) ----------
    # the 1000-token prompt of phase 4b runs all four q4b shapes at M = 1024,
    # the Q8_0 24-token prompt of phase 4c all four q8b shapes at M = 32
    for kind, m, label, n, k, layers in (
            ("q4b", 1024, "gate_up", 28672, 4096, 2),
            ("q4b", 1024, "down", 4096, 14336, 3),
            ("q4b", 1024, "qkv", 6144, 4096, 8),
            ("q4b", 1024, "o", 4096, 4096, 12),
            ("q4b", 512, "gate_up", 28672, 4096, 2),
            ("q4b", 512, "down", 4096, 14336, 3),
            ("q4b", 512, "qkv", 6144, 4096, 8),
            ("q4b", 512, "o", 4096, 4096, 12),
            ("q4b", 2048, "gate_up", 28672, 4096, 2),
            ("q4b", 2048, "down", 4096, 14336, 3),
            ("q4b", 2048, "qkv", 6144, 4096, 8),
            ("q4b", 2048, "o", 4096, 4096, 12),
            ("q8b", 32, "gate_up", 28672, 4096, 2),
            ("q8b", 32, "down", 4096, 14336, 2),
            ("q8b", 32, "qkv", 6144, 4096, 8),
            ("q8b", 32, "o", 4096, 4096, 12),
            ("q8b", 512, "gate_up", 28672, 4096, 2),
            ("q8b", 512, "down", 4096, 14336, 2)):
        if kind == "q4b":
            qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        else:
            qs, sc, _ = rand_q8b(gen, layers, n, k, 32, dev)
        wbytes = qs[0].numel() + sc[0].numel() * 2
        # bf16 activations, so the wrapper's cast is not timed with the kernel
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = Q.qmm_dequant(x, qs[0], sc[0])
        want = Q.qmm_dequant_plain(x, qs[0], sc[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_dequant/{kind}/{label}/M={m}", got, want, 1e-3)
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_dequant(x, qs[i], sc[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_dequant_plain(x, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        lib = time_ms(torch, lambda i: torch.matmul(x, w[i]), layers)
        del w
        entry("qmm_dequant", "llamafile_tpu_torch/csrc/qmm_dequant.cu",
              "llamafile_tpu/ops/qmatmul.py:1761", f"{kind} {label} M={m} N={n} K={k}",
              err, ms, plain, lib, wbytes + 2 * m * k + 4 * m * n, 2 * m * n * k,
              BF16_FLOP_PER_S)
        del qs, sc
        torch.cuda.empty_cache()

    # --- qmm_q8_m1: the Q8_0 decode GEMVs and the Q6_K lm head -----------
    for label, g, n, k, layers in (("qkv Q8_0", 32, 6144, 4096, 8),
                                   ("o Q8_0", 32, 4096, 4096, 12),
                                   ("gate_up Q8_0", 32, 28672, 4096, 2),
                                   ("down Q8_0", 32, 4096, 14336, 2),
                                   ("lm_head Q8_0", 32, 129024, 4096, 1),
                                   ("lm_head Q6_K", 16, 129024, 4096, 1)):
        qs, sc, _ = rand_q8b(gen, layers, n, k, g, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x, nrm, 1e-5)
        got = Q.qmm_q8_m1(xq, sx, qs[0], sc[0])
        want = Q.qmm_q8_m1_plain(xq, sx, qs[0], sc[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_q8_m1/{label}", got, want, 1e-5)
        ms = time_ms(torch, lambda i: Q.qmm_q8_m1(xq, sx, qs[i], sc[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_q8_m1_plain(xq, sx, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_q8_m1", "llamafile_tpu_torch/csrc/qmm_q8_m1.cu",
              "llamafile_tpu/ops/qmatmul.py:684", f"{label} M=1 N={n} K={k}", err, ms,
              plain, lib, qs[0].numel() + sc[0].numel() * 2 + k + k // 8 + 4 * n,
              2 * n * k)
        del qs, sc
        torch.cuda.empty_cache()

    # --- flash_prefill: causal prefill attention over the fresh prompt ----
    hq, hkv, hd = 32, 8, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for t, sets in ((1024, 2), (512, 4), (2048, 2)):
        # bf16 inputs, so the wrapper's casts are not timed with the kernel
        qkv = [[torch.randn((1, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
                for h in (hq, hkv, hkv)] for _ in range(sets)]
        scale = hd ** -0.5
        got = A.flash_prefill(*qkv[0], scale)
        want = A.flash_prefill_plain(*qkv[0], scale)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("flash_prefill: non-finite output")
        # row by row (one query, one head): two bf16 steps of an output, as
        # in tests/test_torch_cuda.py; the control drops each query's
        # diagonal key tile and must fail it
        err = (got - want).abs().max().item()
        row = row_rel_err(got, want)
        fault = row_rel_err(flash_prefill_tile_fault(*qkv[0], scale), want)
        log(f"  flash_prefill/T={t}: max_abs_err {err:.6g}; per row {row:.6g} of the "
            f"row's max (tol {FLASH_ROW_TOL}); diagonal-tile fault control {fault:.6g}")
        if not row <= FLASH_ROW_TOL < fault:
            raise AssertionError(f"flash_prefill T={t}: row error {row}, control {fault}")
        ms = time_ms(torch, lambda i: A.flash_prefill(*qkv[i], scale), sets)
        plain = time_ms(torch, lambda i: A.flash_prefill_plain(*qkv[i], scale), sets)
        heads = [[a.transpose(1, 2) for a in trio] for trio in qkv]
        lib = time_ms(torch, lambda i: sdpa(*heads[i], is_causal=True, scale=scale,
                                            enable_gqa=True), sets)
        check_close(f"flash_prefill/T={t} vs sdpa (yardstick sanity)", got,
                    sdpa(*heads[0], is_causal=True, scale=scale,
                         enable_gqa=True).transpose(1, 2), 2e-2)
        entry("flash_prefill", "llamafile_tpu_torch/csrc/flash_prefill.cu",
              "llamafile_tpu/ops/attention.py:57", f"Hq={hq} Hkv={hkv} D={hd} T={t}",
              err, ms, plain, lib, (t * (hq + 2 * hkv) + t * hq) * hd * 2,
              2 * hq * hd * t * (t + 1), BF16_FLOP_PER_S)      # bf16 values out
        del qkv, heads, got, want
        torch.cuda.empty_cache()

    # --- qmm_moe_m1: the fused decode FFN, layer as expert ---------------
    d, dff, layers = 4096, 14336, 2
    gq, gs, gb = rand_q4b(gen, layers, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, layers, d, dff, dev)
    x = torch.randn((1, d), generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x, 1 + 0.1 * torch.randn(d, generator=gen, device=dev), 1e-5)
    args = lambda i: (xq, sx, gq[i], gs[i], gb[i], dq[i], ds[i], db[i])
    got = Q.qmm_moe_m1(*args(0))
    want = Q.qmm_moe_m1_plain(*args(0))
    torch.cuda.synchronize()
    err = check_close("qmm_moe_m1", got, want, 2e-3)
    ms = time_ms(torch, lambda i: Q.qmm_moe_m1(*args(i)), layers)
    plain = time_ms(torch, lambda i: Q.qmm_moe_m1_plain(*args(i)), layers)
    entry("qmm_moe_m1", "llamafile_tpu_torch/csrc/qmm_moe_m1.cu",
          "llamafile_tpu/ops/qmatmul.py:1037", f"ffn M=1 d={d} d_ff={dff}",
          err, ms, plain, None,
          q4b_bytes(gq, gs, gb) + q4b_bytes(dq, ds, db) + d + d // 8 + 4 * d,
          2 * (2 * dff * d + d * dff))
    del gq, gs, gb, dq, ds, db

    # --- flash_decode_write: decode attention + KV-row write --------------
    nl, s_len, hq, hkv, hd, s_eff, pos = 32, 2048, 32, 8, 128, 1024, 700
    scale = hd ** -0.5
    k3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(torch.bfloat16)
    v3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(torch.bfloat16)
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    kn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    vn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k3b, v3b = k3.clone(), v3.clone()
    got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 5, p, scale, hkv, s_limit=s_eff)
    want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 5, p, scale, hkv, s_eff)
    torch.cuda.synchronize()
    err = check_close("flash_decode_write", got, want, 2e-2)
    if not (torch.equal(k3, k3b) and torch.equal(v3, v3b)):
        raise AssertionError("flash_decode_write: the written cache rows differ")
    del k3b, v3b
    ms = time_ms(torch, lambda i: A.flash_decode_write_stacked(
        q, k3, v3, kn, vn, i, p, scale, hkv, s_limit=s_eff), nl)
    plain = time_ms(torch, lambda i: A.flash_decode_write_plain(
        q, k3, v3, kn, vn, i, p, scale, hkv, s_eff), nl)
    qs4 = q.to(torch.bfloat16).reshape(1, hq, 1, hd)
    kv = lambda t, i: t[i, :, :pos + 1].reshape(1, pos + 1, hkv, hd).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(torch, lambda i: sdpa(qs4, kv(k3, i), kv(v3, i), scale=scale,
                                        enable_gqa=True), nl)
    sdpa_out = sdpa(qs4, kv(k3, 5), kv(v3, 5), scale=scale, enable_gqa=True)
    check_close("flash_decode_write vs sdpa (yardstick sanity)",
                got.reshape(1, hq, 1, hd), sdpa_out, 2e-2)
    row = hkv * hd
    entry("flash_decode_write", "llamafile_tpu_torch/csrc/flash_decode_write.cu",
          "llamafile_tpu/ops/attention.py:217",
          f"Hq={hq} Hkv={hkv} D={hd} s_eff={s_eff} pos={pos}", err, ms, plain, lib,
          2 * pos * row * 2 + 2 * row * 2 + (2 * hq * hd + 2 * row) * 4,
          4 * pos * hq * hd, BF16_FLOP_PER_S)
    del k3, v3
    torch.cuda.empty_cache()
    return list(rows.values())


def _to(params, dev):
    import dataclasses
    from llamafile_tpu_torch.models.llama import LlamaParams
    mv = lambda v: None if v is None else v.to(dev)
    layers = dataclasses.replace(params.layers, **{
        f.name: mv(getattr(params.layers, f.name))
        for f in dataclasses.fields(params.layers)})
    return LlamaParams(params.tok_embd.to(dev), layers, params.out_norm.to(dev),
                       params.output.to(dev))


@contextlib.contextmanager
def op_trace(rec):
    """While open, every product (qmatmul, qmatmul_moe), activation
    quantization (its int8 codes) and attention call of the forward appends
    (label, output on the CPU, inputs) to the list rec[-1], in call order;
    inputs (on the CPU) are kept for the prefill attention only. Nothing
    inside the fused FFN is kept: its plain version quantizes its hidden
    activations in torch, the kernel inside itself."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import qmatmul as Q
    saved, inside = [], [0]

    def wrap(mod, name, label, opaque=False, keep_inputs=False):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def traced(*a, **kw):
            inside[0] += opaque
            try:
                out = fn(*a, **kw)
            finally:
                inside[0] -= opaque
            if not inside[0]:
                ins = [t.cpu() if hasattr(t, "cpu") else t for t in a] if keep_inputs else None
                rec[-1].append((label(*a), (out[0] if isinstance(out, tuple) else out).cpu(),
                                ins))
            return out
        setattr(mod, name, traced)
    wrap(LM, "qmatmul", lambda x, qt, li=None, *_: "lm head" if li is None
         else f"L{li} product N={qt.shape[0]}")
    wrap(LM, "qmatmul_moe", lambda x, gu, dn, rows, *_: f"L{rows[0]} fused ffn", True)
    wrap(Q, "quantize_activations_g32", lambda x, *_: f"codes M={x.shape[0]} K={x.shape[1]}")
    wrap(LM, "flash_prefill", lambda *_: "prefill attention", keep_inputs=True)
    wrap(LM, "flash_decode_write_stacked", lambda *a: f"L{a[5]} decode attention")
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def trace_report(steps_card, steps_cpu):
    """One line a forward call: where card and CPU first part, and how far.
    A quantization's int8 codes are compared code by code; every other
    output by max |diff| / max |CPU value|. Returns (lines, the largest
    parting of a product whose input codes agree on both sides): a fault in
    an int8-activation kernel shows there, whatever parted before it."""
    from llamafile_tpu_torch.testing import rel_err
    lines, same_in = [], 0.0
    for i, (card, cpu) in enumerate(zip(steps_card, steps_cpu)):
        n_q = flips = q_flipped = 0
        first, worst, codes_agree = None, (0.0, ""), False
        for j, ((lab, a, _), (lab_b, b, _)) in enumerate(zip(card, cpu)):
            assert lab == lab_b, (lab, lab_b)
            if not a.dtype.is_floating_point:
                n_q += 1
                nf = int((a != b).sum())
                codes_agree = nf == 0
                if nf:
                    q_flipped += 1
                    flips += nf
                    step = int((a.int() - b.int()).abs().max())
                    if first is None:
                        first = f"call {j} {lab}: {nf} codes differ, by up to {step}"
                continue
            e = rel_err(a, b)
            worst = max(worst, (e, f"call {j} {lab}"))
            if first is None and e > 1e-4:
                first = f"call {j} {lab}: {e:.3g}"
            if codes_agree and ("product" in lab or lab == "lm head"):
                same_in = max(same_in, e)
            codes_agree = False
        lines.append(f"step {i}: {len(card)} calls; codes differ in {q_flipped} of {n_q} "
                     f"quantizations ({flips} codes); first parting (codes, or > 1e-4): "
                     f"{first}; largest {worst[0]:.3g} at {worst[1]}")
    return lines, same_in


def prefill_attention_report(torch, dev, card, cpu):
    """For each flash-kernel prefill attention call of one traced prefill:
    the kernel against its plain version on the card's own inputs, row by
    row (it must stay within FLASH_ROW_TOL), and the row where card and CPU
    part most, with that row's two largest scores: with the synthetic
    weights' large activations softmax is near one-hot, and a near tie
    there turns on one bf16 step of a q or k element."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    lines = []
    for j, ((lab, got, ins), (_, want, _)) in enumerate(zip(card, cpu)):
        if ins is None or not A._use_flash(ins[0].shape[1], ins[0].shape[3]):
            continue
        q, k, v, scale = ins[:4]
        on_card = [t.to(dev) for t in (q, k, v)]
        same = row_rel_err(A.flash_prefill(*on_card, scale),
                           A.flash_prefill_plain(*on_card, scale))
        part = (got - want).abs().amax(-1)[0]                   # [T, Hq]
        t, h = divmod(int(part.argmax()), part.shape[1])
        bf = lambda a: a.to(torch.bfloat16).float()
        s = bf(q[0, t, h]) @ bf(k[0, :t + 1, h // (q.shape[2] // k.shape[2])]).T * scale
        top = torch.topk(s, 2).values.tolist()
        lines.append(f"call {j} {lab}: kernel vs plain on the card's inputs {same:.3g} "
                     f"per row (tol {FLASH_ROW_TOL}); card vs CPU part most at row {t} "
                     f"head {h} ({part[t, h].item() / want[0, t, h].abs().max().item():.3g} "
                     f"of its max), top-2 scores {top[0]:.6g}, {top[1]:.6g} (std "
                     f"{s.std().item():.4g})")
        if same > FLASH_ROW_TOL:
            raise AssertionError(f"flash_prefill on the path's inputs: {same}")
    return lines


def whole_path_check(torch, dev, quant="Q4_K", n_prompt=32, n_decode=8):
    """Two layers at llama3-8b width: card (kernels) vs CPU (plain versions).
    The prompt is padded to its prefill bucket, as Engine.prefill does.
    Every op's output is kept on both sides, and trace_report's lines are
    logged: the op at which card and CPU first part in each step."""
    from llamafile_tpu_torch.models.llama import forward, init_cache, stack_layers
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import bucket_len
    cfg, params = make_synthetic_llama("llama3-8b-2l", quant, seed=1, fuse=True,
                                       device=dev)
    gpu = stack_layers(params)
    cpu = _to(gpu, "cpu")
    bucket = bucket_len(n_prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :n_prompt] = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                       generator=torch.Generator().manual_seed(2))
    max_len = max(256, bucket + n_decode)
    caches = {d: init_cache(cfg, 1, max_len, device=d) for d in ("cuda", "cpu")}
    logits = {"cuda": [], "cpu": []}
    rec = {"cuda": [], "cpu": []}

    def run(d, p, tokens, pos, **kw):
        rec[d].append([])
        with op_trace(rec[d]):
            lg, _ = forward(p, cfg, tokens.to(d),
                            torch.tensor([pos], dtype=torch.int32, device=d), caches[d], **kw)
        logits[d].append(lg[0, -1].float().cpu())
    for d, p in (("cuda", gpu), ("cpu", cpu)):
        run(d, p, toks, 0, fresh_prefill=True,
            last_idx=torch.tensor([n_prompt - 1], device=d))
    nxt = int(logits["cuda"][0].argmax())
    for step in range(n_decode):
        for d, p in (("cuda", gpu), ("cpu", cpu)):
            run(d, p, torch.tensor([[nxt]]), n_prompt + step, attn_len=max_len)
        nxt = int(logits["cuda"][-1].argmax())
    lines, same_in = trace_report(rec["cuda"], rec["cpu"])
    for line in lines:
        log(f"  {quant} trace {line}")
    log(f"  {quant} trace: products on agreeing input codes part by at most "
        f"{same_in:.3g} (tol 1e-5, the int8 kernels' own)")
    if same_in > 1e-5:
        raise AssertionError(f"whole path {quant}: a product parts on equal inputs")
    for line in prefill_attention_report(torch, dev, rec["cuda"][0], rec["cpu"][0]):
        log(f"  {quant} trace {line}")
    del rec
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  {quant} prompt {n_prompt} (bucket {bucket}) step {i}: top-1 card "
            f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"whole path {quant} step {i}: card and CPU disagree")
    del gpu, cpu, params
    torch.cuda.empty_cache()


def counted_generate(torch, eng, prompt, n_new):
    """One greedy Engine.generate of n_new tokens after a warm-up run (first
    launches of each kernel at these shapes, allocator; not counted), with
    every launch count set to 0 just before and read just after. Returns
    (tokens, counts, time to first token s, decode s after the first)."""
    from llamafile_tpu_torch.ops import kernel_wrappers, reset_launch_counts
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=0.0)
    list(eng.generate("", max_tokens=min(n_new, 9), sampling=sp, stop_on_eog=False,
                      prompt_ids=prompt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, t_first = [], None
    for tid, _ in eng.generate("", max_tokens=n_new, sampling=sp, stop_on_eog=False,
                               prompt_ids=prompt):
        if t_first is None:
            t_first = time.perf_counter()
        toks.append(tid)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = {w.__name__: w.launches for w in kernel_wrappers()}
    if len(toks) != n_new or any(t < 0 or t >= eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"generate produced {toks}")
    return toks, counts, t_first - t0, t_end - t_first


def check_counts(counts, expect, what):
    """Exact launch counts: every kernel not named in expect launched 0 times."""
    want = {name: expect.get(name, 0) for name in counts}
    log(f"  launches in {what}: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{what} did not run through the kernels as expected")


def decode_report(torch, read, steps, ttft_s, decode_s, prompt_note):
    step_ms = decode_s / steps * 1e3
    bound = read / HBM_BYTES_PER_S * 1e3
    log(f"  time to first token {ttft_s * 1e3:.2f} ms ({prompt_note})")
    log(f"  decode {steps / decode_s:.2f} tok/s = {step_ms:.3f} ms a step; "
        f"weight-read bound {bound:.3f} ms a step ({bound / step_ms:.1%})")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return step_ms


def build_engine(torch, dev, quant):
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3-8b", quant, seed=0, fuse=True, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b {quant} (32 layers, fused, stacked) in {time.time() - t0:.1f} s; "
        f"decode reads {read / 1e9:.3f} GB of weights a step")
    return eng, read


def main_path(torch, dev):
    """The port's main paths at full width through their user entry points
    (phases 4, 4b, 4c). Every timed run comes before the first profiler
    session of the process, and the profiles follow on fresh engines.
    Returns the launch counts of each timed run."""
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=0.0)
    eng, read = build_engine(torch, dev, "Q4_K")
    n_layers = eng.cfg.n_layers
    prompt = [int(t) for t in torch.randint(3, eng.cfg.n_vocab, (24,),
                                            generator=torch.Generator().manual_seed(3))]
    n_new = 64
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n_layers,
                          "qmm_moe_m1": 64 * steps,
                          "flash_decode_write_stacked": 32 * steps}, "phase 4")
    step_q4 = decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")

    log("phase 4b: the same engine, a 1000-token prompt (bucket 1024)")
    long_prompt = [int(t) for t in torch.randint(3, eng.cfg.n_vocab, (1000,),
                                                 generator=torch.Generator().manual_seed(4))]
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_dequant": 4 * n_layers, "flash_prefill": n_layers,
                                "qmm_txn_m1": 1}, "phase 4b")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
    del eng
    torch.cuda.empty_cache()

    log("phase 4c: main path, llama3-8b Q8_0, 32 layers, Engine.generate")
    eng, read = build_engine(torch, dev, "Q8_0")
    _, counts_c, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts_c, {"qmm_q8_m1": 1 + (4 * n_layers + 1) * steps,
                            "qmm_dequant": 4 * n_layers,
                            "flash_decode_write_stacked": n_layers * steps}, "phase 4c")
    step_q8 = decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")

    log("profiles of phase 4c's Q8_0 decode, then of phase 4 and 4b on a rebuilt "
        "Q4_K engine")
    device_busy(torch, eng, prompt, sp, step_q8)
    del eng
    torch.cuda.empty_cache()
    eng, _ = build_engine(torch, dev, "Q4_K")
    device_busy(torch, eng, prompt, sp, step_q4)
    prefill_profile(torch, eng, long_prompt)
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_b, counts_c]


def device_kernels(prof):
    """(device time in us by kernel name, number of device activities)."""
    from torch.autograd import DeviceType
    by_name, n_act = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            n_act += 1
    return by_name, n_act


def prefill_profile(torch, eng, prompt):
    """Device time by kernel of one prefill, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    cache = eng.new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.prefill(cache, prompt)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3
    if busy_ms == 0:
        log("  prefill device time: not measured (the profiler recorded no kernels)")
        return
    log(f"  prefill under the profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, "
        f"{n_act} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3:8.4f} ms  {name[:90]}")


def device_busy(torch, eng, prompt, sp, step_ms):
    """Kernel time of one 8-step decode chunk from a profiler trace, against
    the unprofiled step time: the device's busy share of a decode step."""
    from torch.profiler import ProfilerActivity, profile
    cache = eng.new_cache()
    last, cache = eng.prefill(cache, prompt)
    tok = last.argmax()[None].to(torch.int32)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=tok.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.decode(tok, pos, cache, None, sp, 8, attn_len=256)
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / 8
    if busy_ms == 0:
        log("  device busy share: not measured (the profiler recorded no kernels)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms decode step "
        f"({busy_ms / step_ms:.1%}); idle {1 - busy_ms / step_ms:.1%}")
    log(f"  {n_act / 8:.1f} device activities (kernels, copies, fills) a step: "
        f"{step_ms * 1e3 / (n_act / 8):.1f} us of step time each")
    for name, us in top:
        log(f"    {us / 8 / 1e3:8.4f} ms/step  {name[:90]}")
    # the host side: the next 8 steps under cProfile, by function's own time
    prof_py = cProfile.Profile()
    t0 = time.perf_counter()
    prof_py.enable()
    eng.decode(tok, pos, cache, None, sp, 8, attn_len=256)
    torch.cuda.synchronize()
    prof_py.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    stats = pstats.Stats(prof_py).stats
    log(f"  host time by function, cProfile on ({wall_ms:.3f} ms a step with it):")
    for (path, line, fn), (_, calls, own, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"    {own / 8 * 1e3:8.4f} ms/step {calls / 8:7.1f} calls  "
            f"{fn[:60]} ({os.path.basename(path)}:{line})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: chip_smoke.py needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from llamafile_tpu_torch import resolve_device
        from llamafile_tpu_torch.ops import _build
    except ImportError as e:
        print(f"error: llamafile_tpu_torch is not beside chip_smoke.py ({e})",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    log(f"built {len(_build.SOURCES)} kernel libraries in {build_s:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log("phase 2: kernels against their plain versions at the main path's shapes")
    rows = kernel_phases(torch, dev, gen)
    log("phase 3: whole paths, llama3-8b width, 2 layers: card vs CPU plain")
    whole_path_check(torch, dev)
    whole_path_check(torch, dev, "Q4_K", n_prompt=300, n_decode=2)
    whole_path_check(torch, dev, "Q8_0", n_prompt=24, n_decode=4)
    log("phase 4: main path, llama3-8b Q4_K, 32 layers, Engine.generate")
    runs = main_path(torch, dev)
    for r in rows:
        key = "flash_decode_write_stacked" if r["name"] == "flash_decode_write" else r["name"]
        r["launches"] = sum(c[key] for c in runs)
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was launched by no main-path run")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
