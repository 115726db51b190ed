#!/usr/bin/env python3
"""Drive llamafile_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

1. Set-up: the card's name and power limit, torch/CUDA/nvcc versions, and a
   parallel build of every CUDA kernel from llamafile_tpu_torch/csrc/.
2. Each kernel at the shapes of the llama3-8b main paths (Q4_K decode and
   prefill, Q8_0 and Q6_K decode, long-prompt prefill, the serving step at
   8 rows: qmm_txn at M = 8 and paged_attention over bf16 and int8 pages;
   qmm_txn_m1 at the decode step's qkv, o, down (K = 14336) and lm head;
   qmm_txn at its 11 shapes and qmm_txn_g at its four; these, the fused
   FFN, the routed q4b GEMVs and qmm_int8 each with a second launch on the
   same inputs held bit for bit, qmm_txn also with a control whose lo and
   hi scale rows are swapped;
   flash_decode_write at pos 700 / s_eff 1024, pos 1900 / s_eff 2048 and
   phase 4's pos 64 / s_eff 256, two launches on the same inputs bitwise
   equal; the three decode kernels also at head groups of 3 and 16 (24 and
   128 query heads over 8 KV heads), bf16 and int8, and at head_dim 256:
   Gemma-2-9B's 16 query heads over 8 KV heads and Gemma-2B's 8 over 1;
   the unrolled prefill's qmm_planes; flash_decode and paged_attention
   over bf16 and int8 (one launch of thread-block clusters, a group of up
   to 16 heads from one K/V read; a larger group's label gives the
   wrapper's chunk count); flash_prefill (wgmma) at T = 512, 1024, 2048; the
   MoE kernels at Mixtral-8x7B width: the routed fused FFN and the routed
   q4b and q8b GEMVs at a decode step's 2 slots, qmm_txn_g at 16 and 512
   slots, qmm_planes_g at 2048, each with a control whose expert ids are
   swapped; the int8 prefill GEMM qmm_i8p at the four products at M =
   1024, 512 and 128 and gate|up at M = 300, on layer 1 of a stack (and at
   gate|up M = 1024 on unrolled layers), bitwise equal to its plain version,
   with a control whose block scales are swapped, beside qmm_dequant at the
   same shape; the q4b
   flavours' kernels: qmm_int8 at M = 8 on qkv, o, gate|up, down (layers
   i > 0 of a stack) and the unstacked lm head, and gate|up and down at
   M = 32, with a control whose lo and hi scale rows are swapped, beside
   qmm_txn at the same shape; qmm_planes on layer 1 of a stack, gate|up at
   M = 1024 and 8; qmm_dequant on one-hot rows, x = I at K = 1024, whose
   outputs must equal dequant_bf16 exactly for q4b, q8b g32 and g16),
   held against its plain PyTorch version on the same inputs (the
   tolerances of the CPU and card tests) and timed on the device: a run of launches cycling over
   enough layers of weights to spill the 50 MB L2 (as decode does) is
   captured in a CUDA graph and replayed between CUDA events, median of 25
   replays, so the host's dispatch cost is left out. Timed: the kernel, its
   plain version, one PyTorch library call computing the same function where
   there is one (for qmm_i8p, torch._int_mm on the same codes without the
   per-block scales), and the bound (bytes over the card's memory rate, or
   operations over its peak rate, whichever is larger).
3. Whole paths at two layers of llama3-8b width, card (kernels) against the
   same model on the CPU (plain versions): Q4_K with a 32-token prompt and a
   decode step, Q4_K with a 300-token prompt (bucket 512) and a decode
   step, Q8_0 with a 24-token prompt (bucket 32) and a decode step, and
   the paged decode (forward_paged_decode) of 4 rows admitted at prompts of
   24, 64, 200 and 300 tokens, 1 step; the Q4_K_M recipe at two layers
   (layer 1 Q6_K V and down, unrolled) with a 300-token prompt and a decode
   step; Q4_K with a dense int8 KV cache, 32-token prompt, 1 step; Q4_K
   with the int8 prefill companions (int8_prefill_params), 300-token prompt
   and a step, each qmm_i8p call rerun on its own int8 codes and scales;
   TinyLlama's widths at two layers (head_dim 64) with a max_seq_len of
   1000: the Engine's prefill and 2 decode steps on a bf16 cache, then on the
   card Engine.generate and 3 requests through the batcher, every decode
   attention on the einsum or gather route with no decode kernel launch,
   and the 3-row paged decode card against CPU; Llama-3.2-3B's widths at
   two layers (a head group of 3): the Engine's prefill and a decode step
   over its bf16 cache (300-token prompt) and its int8 cache (40 tokens),
   then on the card Engine.generate and 4 requests through the batcher,
   every decode attention a kernel launch, and the 4-row paged decode card
   against CPU; the same checks at head_dim 256 (gemma-2b-widths-2l:
   Gemma-2B's widths in the llama layout, 8 query heads over 1 KV head, two
   layers; 1 decode step, the paged decode of 2 rows), where
   flash_decode_write, flash_decode and paged_attention run at D = 256; two
   layers at Mixtral-8x7B width (mixtral-8x7b-2l): Q4_K stacked (24-token
   prompt: qmm_txn_g; a decode step on the routed fused FFN), the Q4_K_M
   recipe unrolled (300-token prompt: layer 0's qmm_planes_g, layer 1's
   dense expert loop (Q6_K down); a decode step: the routed GEMVs), and
   the paged decode at 4 rows (the fused FFN) and 8 rows (qmm_txn_g), one
   step each (the Mixtral checks' CPU side is the slowest of the phase); the
   routers held on the card's own inputs and their choices compared row by
   row (a row routed otherwise on the two sides is reported, its logits not
   held), and one decode step's MoE FFN calls run under
   torch.cuda.set_sync_debug_mode("error"); then under the q4b flavours
   (LLAMAFILE_TPU_Q4B, qmatmul.Q4B_KERNEL set for both sides): Q4_K with
   the 32-token prompt and a decode step under int8 and under planes, and
   the 300-token prompt and a step under int8 (qmm_int8, and the stacked
   planes kernel at bucket 512, as under planes), Q8_0 under int8 (24-token
   prompt, 1 step, decode on the dequant GEMM), the 4-row paged decode
   under int8 (1 step), and Mixtral Q4_K stacked under int8 (24-token
   prompt, 1 step on _routed_fallback, its calls counted). Each
   is traced op by op: for each step, the first product, quantization or
   attention call where card and CPU part, and the largest parting; every
   product is rerun through its plain version on the card's own inputs and
   must agree within its phase-2 limit, and so must every int8-cache
   decode attention.
4. The main paths at full width through Engine.generate, each with every
   launch count set to 0 just before it and read just after, and checked
   exactly:
   4. make_synthetic_llama("llama3-8b", Q4_K, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate, time to
      first token and the weight-read bound;
   4b. the same engine, a 1000-token prompt (bucket 1024): time to first
      token through the dequant GEMM and the flash prefill;
   4d. phase 4's weights with a dense int8 KV cache: 64 tokens, decode
      attention on flash_decode (32 launches a step);
   4f. phase 4's engine under LLAMAFILE_TPU_Q4B=int8, then =planes: 64
      tokens from the 24-token prompt (129 qmm_int8 or qmm_planes launches a
      step: 4 a layer and the head; no fused FFN), the 1000-token prompt's
      TTFT (the stacked planes kernel, 128 launches); under int8 also the
      HTTP server at 4 slots, 4 greedy requests, those of the shortest and
      longest prompt against themselves served alone (ALONE_LENGTHS; a 4-row
      step padded to 8 on qmm_int8);
   4e. phase 4's model built under LLAMAFILE_TPU_I8P=1 (phase 4's engine
      dropped first): 64 tokens from the 24-token prompt (no companion
      read), then the 1000-token prompt's TTFT with 128 qmm_i8p launches
      (4 fused products x 32 layers); the companions' bytes, peak memory;
   4c. make_synthetic_llama("llama3-8b", Q8_0, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate against its
      weight-read bound, and time to first token.
5. Serving at full width: the port's HTTP Server (8 slots, paged bf16 KV)
   over phase 4's Q4_K engine, in process on 127.0.0.1; 8 client threads
   send 16 requests (prompts of 24, 128, 500 and 1000 tokens, 64 new
   tokens, 12 greedy and 4 sampled, half streamed, 2 through the chat
   endpoint). Wall time, output tok/s, TTFT by prompt length, the fused
   decode step at 8 rows against its bound, peak memory; exact launches
   from the batcher's own tallies; three requests served again one at a
   time by a fresh batcher (greedy at the shortest and longest prompt, one
   sampled) must give the same token ids.
6. llama3-8b by llama.cpp's Q4_K_M recipe (testing.make_q4_k_m_llama: 16
   of 32 layers with Q6_K V and down, Q6_K head), unrolled, through
   Engine.generate (64 tokens from a 24-token prompt, then the 1000-token
   prompt's TTFT on qmm_planes) and the HTTP server at 4 slots (4 greedy
   requests, those of the shortest and longest prompt against themselves
   served alone), launches exact.
7. mixtral-8x7b-8l (Mixtral-8x7B's widths, top-2 of 8 experts, 8 layers):
   7a Q4_K stacked through Engine.generate (64 tokens from a 24-token
   prompt; the 1000-token prompt's TTFT), 7b the same by the Q4_K_M recipe
   (unrolled), 7c the HTTP server at 8 slots over 7a's engine, 8 greedy
   requests (prompts of 24, 128, 500 and 1000 tokens, two each), the four
   of the shortest and longest prompt against themselves served alone;
   launches exact, the decode rate against the
   routed weight-read bound (models.synthetic.decode_read_bytes).
8. llama3.2-3b (Llama-3.2-3B's widths, 28 layers, a head group of 3), Q4_K
   stacked: Engine.generate of 32 tokens from the 24-token prompt, launches
   exact, the decode rate against its weight-read bound; the HTTP server at
   4 slots, 4 greedy requests, those of the shortest and longest prompt
   against themselves served alone; no decode attention call on the einsum
   or gather route.
   Phases run in the order 4, 4b, 4d, 5, 4f, 4e, 4c, 6, 7, 8. Then, after every timed
   run (so that no profiler session of the process precedes a timing),
   profiles: a 2-step decode chunk of each model (7a, 7b, and 4c, 4 and
   4f's int8 on rebuilt engines) under torch.profiler (the device's busy
   share of a step) and under cProfile (host time by function), one
   1000-token prefill (device time by kernel), and one fused 8-row serving
   chunk (busy share).

Every phase header (and each phase-3 check's) prints the seconds since the
start and those the previous one took; {"phase_seconds": ...} sums them up
before the launches line.

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the lines before it hold every kernel's
launches summed over the counted runs of phases 4 to 7 ({"launches": ...},
with qmm_planes' launches on a stacked layer's view apart as
"qmm_planes_stacked"), the kernel table (one JSON object with an entry a
kernel: the numbers of its first shape, the main path's heaviest, every
measured shape under "shapes", and those launches; qmm_planes' entry also
"stacked_launches") and the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import copy
import cProfile
import json
import os
import pstats
import re
import socket
import statistics
import subprocess
import sys
import threading
import time

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores
SAMPLES = 25
FLASH_ROW_TOL = 1.5e-2
PAGED_ROW_TOL = 1e-5              # of each (row, head)'s largest output
# On the serving path's own inputs the synthetic weights give attention
# scores of std 1e3 to 1e5, so f32 sums in another order move a score by
# about 1e-2: the kernel and its plain version part by up to 2.3e-4 of a
# row's max there (H100 readings), and the limit keeps room over that. Near
# one-hot softmax also hides the faulty controls there (a key made visible
# or a page dropped carries no weight): phase 2 holds those.
PAGED_PATH_TOL = 1e-3
PLANES_TOL = 1e-3                 # f32 out, as the dequant GEMM
PLANES_BF16_TOL = 2 ** -7         # bf16 out: one bf16 step of the largest
DECODE_BF16_ROW_TOL = 2e-2        # p rounded to bf16 against another max
DECODE_INT8_ROW_TOL = 1e-5        # all f32 on the same values
# qmm_i8p repeats its plain version's roundings in the same order (exact
# int32 block dots, the f32 block updates in K order): 1e-6 of the largest
I8P_TOL = 1e-6
KV_BYTES_PER_TOKEN = 32 * 8 * 128 * 2 * 2    # llama3-8b bf16 K and V, 32 layers


T0 = time.time()


def log(*a):
    print(*a, flush=True)


PHASE_TIMES = []                  # (header, seconds since the start)


def phase(msg):
    """A phase header, with the seconds since the script started and those
    the previous header's phase took."""
    now = time.time() - T0
    took = f", previous {now - PHASE_TIMES[-1][1]:.1f} s" if PHASE_TIMES else ""
    PHASE_TIMES.append((msg.strip(), now))
    log(f"{msg} [{now:.1f} s{took}]")


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


def check_repeat(name, again, got):
    """A second launch on the same inputs must give the same bits (the
    split-K combine sums in a fixed order)."""
    if not again.equal(got):
        raise AssertionError(f"{name}: a second launch on the same inputs differs in "
                             f"{(again != got).sum().item()} elements")
    log(f"  {name}: a second launch gives the same bits")


def check_close(name, got, want, rel):
    from llamafile_tpu_torch.testing import rel_err
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max_abs_err {err:.6g} (max |ref| {want.float().abs().max().item():.6g}, "
        f"tol {rel} x max)")
    if not rel_err(got, want) <= rel:
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{err} > {rel} x max |ref|")
    return err


@contextlib.contextmanager
def q4b_flavour(name):
    """The port's q4b kernel flavour (qmatmul.Q4B_KERNEL, which
    LLAMAFILE_TPU_Q4B sets at import) set to `name` inside the block."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    old, Q.Q4B_KERNEL = Q.Q4B_KERNEL, name
    try:
        yield
    finally:
        Q.Q4B_KERNEL = old


def flavour_note() -> str:
    """The q4b flavour in force, for a label ("" for the default txn)."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    return "" if Q.q4b_flavour() == "txn" else f", LLAMAFILE_TPU_Q4B={Q.Q4B_KERNEL}"


def kernel_phases(torch, dev, gen):
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops.repack import q4b_codes
    from llamafile_tpu_torch.testing import (flash_prefill_tile_fault, planes_fault, rand_q4b,
                                             rand_q8b, rel_err, row_rel_err, txn_scale_swap)
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

    # --- qmm_txn_m1: the decode GEMVs (qkv, o, lm head; down is the fused
    # FFN's phase B on the same body, timed here alone) -------------------
    for label, n, k, layers in (("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12),
                                ("down", 4096, 14336, 3), ("lm_head", 129024, 4096, 1)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x, nrm, 1e-5)
        got = Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_m1_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_txn_m1/{label}", got, want, 1e-5)
        check_repeat(f"qmm_txn_m1/{label}", Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0]), got)
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
    # (the main path's 24-token prompt runs all four at M = 32), and the
    # serving step's products at M = 8 rows, the unstacked lm head too;
    # then phase 8's Llama-3.2-3B products (storage N padded to 2048): its
    # 24-token prefill at M = 32 and its 4-slot server's rows at M = 4
    for m, label, n, k, layers in ((32, "gate_up", 28672, 4096, 2),
                                   (32, "down", 4096, 14336, 3),
                                   (32, "qkv", 6144, 4096, 8),
                                   (32, "o", 4096, 4096, 12),
                                   (16, "gate_up", 28672, 4096, 2),
                                   (16, "down", 4096, 14336, 3),
                                   (8, "qkv", 6144, 4096, 8),
                                   (8, "o", 4096, 4096, 12),
                                   (8, "gate_up", 28672, 4096, 2),
                                   (8, "down", 4096, 14336, 3),
                                   (8, "lm_head", 129024, 4096, 1),
                                   (32, "3b_qkv", 5120, 3072, 6),
                                   (32, "3b_o", 4096, 3072, 8),
                                   (32, "3b_gate_up", 16384, 3072, 2),
                                   (32, "3b_down", 4096, 8192, 3),
                                   (4, "3b_qkv", 5120, 3072, 6),
                                   (4, "3b_o", 4096, 3072, 8),
                                   (4, "3b_gate_up", 16384, 3072, 2),
                                   (4, "3b_down", 4096, 8192, 3),
                                   (4, "3b_lm_head", 129024, 3072, 1)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        got = Q.qmm_txn(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        what = f"qmm_txn/{label}/M={m}"
        err = check_close(what, got, want, 1e-5)
        check_repeat(what, Q.qmm_txn(xq, sx, qs[0], sc[0], b[0]), got)
        ctl = rel_err(txn_scale_swap(xq, sx, qs[0], sc[0], b[0]), want)
        log(f"  {what}: swapped-scale-rows control {ctl:.6g} (must exceed 1e-5)")
        if not ctl > 1e-5:
            raise AssertionError(f"{what}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_txn(xq, sx, qs[i], sc[i], b[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_txn_plain(xq, sx, qs[i], sc[i], b[i]), layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_txn", "llamafile_tpu_torch/csrc/qmm_txn.cu",
              "llamafile_tpu/ops/qmatmul.py:276", f"{label} M={m} N={n} K={k}"
              + (" (unstacked)" if label.endswith("lm_head") else ""),
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

    # --- the dequantized weight tile, bit for bit: with x = I (K = 1024
    # one-hot rows) each output sum has one nonzero term, so y[k, :] must
    # equal dequant_bf16's row k (values compared: the f32 sum turns a -0
    # product into +0)
    for kind in ("q4b", "q8b g32", "q8b g16"):
        k, n = 1024, 1040
        qs, sc, _ = (rand_q4b(gen, 1, n, k, dev) if kind == "q4b"
                     else rand_q8b(gen, 1, n, k, int(kind[-2:]), dev))
        got = Q.qmm_dequant(torch.eye(k, device=dev), qs[0], sc[0])
        n_bad = int((got != Q.dequant_bf16(qs[0], sc[0]).float()).sum())
        log(f"  qmm_dequant/{kind} one-hot x = I, K={k} N={n}: {n_bad} of {got.numel()} "
            "outputs differ from dequant_bf16")
        if n_bad:
            raise AssertionError(f"qmm_dequant {kind}: the dequantized tile is not "
                                 "dequant_bf16's, bit for bit")
        del qs, sc, got

    # --- qmm_planes: the unrolled (Q4_K_M) prefill GEMM, unstacked q4b ---
    # phase 6's 1000-token prompt runs all four at M = 1024 (bf16 out);
    # M = 128 is a 128-token bucket (f32 out). Then the stacked form (row
    # 12) on layer 1 of a stack: gate|up at M = 1024 (the stacked prefill
    # under the int8 and planes flavours) and M = 8 (the planes flavour's
    # decode step). The control swaps each superblock's lo and hi scale rows.
    for m, label, n, k, layers, li in ((1024, "gate_up", 28672, 4096, 2, 0),
                                       (1024, "down", 4096, 14336, 3, 0),
                                       (1024, "qkv", 6144, 4096, 8, 0),
                                       (1024, "o", 4096, 4096, 12, 0),
                                       (128, "qkv", 6144, 4096, 8, 0),
                                       (1024, "gate_up", 28672, 4096, 2, 1),
                                       (8, "gate_up", 28672, 4096, 2, 1)):
        qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = Q.qmm_planes(x, qs[li], sc[li])
        want = Q.qmm_planes_plain(x, qs[li], sc[li])
        torch.cuda.synchronize()
        tol = PLANES_TOL if m < 256 else PLANES_BF16_TOL
        where = (f", layer {li} of {layers} (stacked: _qmm_kernel_planes_l, qmatmul.py:1631)"
                 if li else "")
        err = check_close(f"qmm_planes/{label}/M={m}{where} ({got.dtype})", got, want, tol)
        ctl = rel_err(planes_fault(x, qs[li], sc[li]), want)
        log(f"  qmm_planes/{label}/M={m}: swapped-scale-rows control {ctl:.6g} (must exceed {tol})")
        if not ctl > tol:
            raise AssertionError(f"qmm_planes {label}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_planes(x, qs[i], sc[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_planes_plain(x, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        lib = time_ms(torch, lambda i: torch.matmul(x, w[i]), layers)
        del w
        entry("qmm_planes", "llamafile_tpu_torch/csrc/qmm_planes.cu",
              "llamafile_tpu/ops/qmatmul.py:117", f"{label} M={m} N={n} K={k}{where}",
              err, ms, plain, lib,
              qs[0].numel() + sc[0].numel() * 2 + 2 * m * k + (2 if m >= 256 else 4) * m * n,
              2 * m * n * k, BF16_FLOP_PER_S)
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
              err, ms, plain, lib, *prefill_work(t, hq, hkv, hd))    # bf16 values out
        del qkv, heads, got, want
        torch.cuda.empty_cache()

    # --- qmm_moe_m1: the fused decode FFN, layer as expert ---------------
    d, dff, layers = 4096, 14336, 2
    gq, gs, gb = rand_q4b(gen, layers, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, layers, d, dff, dev)
    x = torch.randn((1, d), generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x, 1 + 0.1 * torch.randn(d, generator=gen, device=dev), 1e-5)
    ids = torch.arange(layers, dtype=torch.int32, device=dev)   # the layer id as expert
    one = torch.ones(1, device=dev)
    args = lambda i: (xq, sx, gq, gs, gb, dq, ds, db, ids[i:i + 1], None, one)
    got = Q.qmm_moe_m1(*args(0))
    want = Q.qmm_moe_m1_plain(*args(0))
    torch.cuda.synchronize()
    err = check_close("qmm_moe_m1", got, want, 2e-3)
    check_repeat("qmm_moe_m1", Q.qmm_moe_m1(*args(0)), got)
    ms = time_ms(torch, lambda i: Q.qmm_moe_m1(*args(i)), layers)
    plain = time_ms(torch, lambda i: Q.qmm_moe_m1_plain(*args(i)), layers)
    entry("qmm_moe_m1", "llamafile_tpu_torch/csrc/qmm_moe_m1.cu",
          "llamafile_tpu/ops/qmatmul.py:1037", f"ffn M=1 d={d} d_ff={dff}",
          err, ms, plain, None,
          q4b_bytes(gq, gs, gb) + q4b_bytes(dq, ds, db) + d + d // 8 + 4 * d,
          2 * (2 * dff * d + d * dff))
    del gq, gs, gb, dq, ds, db

    # --- flash_decode_write: decode attention + KV-row write --------------
    # one launch of B * Hkv * head_chunks(G) clusters of FDW_CLUSTER blocks;
    # llama3-8b's group of 4 (32 query heads over 8 KV heads), then the
    # groups of 3 (Llama-3.2-3B, one chunk with masked columns) and 16 (two
    # chunks, each reading the K/V rows) at pos 700, then head_dim 256
    # (DECODE_GROUPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for hq, hkv, hd, cases in DECODE_GROUPS["flash_decode_write"]:
        fdw_phase(torch, dev, gen, entry, sdpa, hq, cases, hkv, hd)

    # --- flash_decode: decode attention over one layer of a dense cache ---
    # bf16 flat [L, B, S, Hkv*D] (the qt contract, flash_decode_stacked) and
    # int8 [L, B, S, Hkv, D] codes with f32 scales (phase 4d's cache), 32
    # layers so the replays spill the L2; pos near the end of s_eff; one
    # launch of thread-block clusters, a group of up to 16 heads from one
    # K/V read. The controls: one masked key made visible,
    # and the second half of the visible keys dropped.
    for hq, hkv, hd, cases in DECODE_GROUPS["flash_decode"]:
        for int8, s_eff in cases:
            flash_decode_phase(torch, dev, gen, entry, sdpa, hq, int8, s_eff, hkv, hd)

    # --- paged_attention: the serving decode attention, 8 rows ------------
    for hq, hkv, hd, cases in DECODE_GROUPS["paged_attention"]:
        for label, lengths, int8 in cases:
            paged_phase(torch, dev, gen, entry, sdpa, hq, label, lengths, int8, hkv, hd)
    i8p_kernel_phase(torch, dev, gen, entry)
    moe_kernel_phases(torch, dev, gen, entry, dequant_bf16)
    int8_kernel_phase(torch, dev, gen, entry, dequant_bf16)
    return list(rows.values())


# the prompt lengths of the served requests (phases 5, 6, 7c and 8), and
# those whose requests are served again alone, the shortest and the longest
SERVE_LENGTHS = (24, 128, 500, 1000)
ALONE_LENGTHS = (24, 1000)

# Phase 2's decode attention shapes by (query heads, KV heads, head dim):
# llama3-8b's 32 over 8 at D = 128 (a group of 4) first, as in earlier runs,
# then 24 over 8 (a group of 3: the shapes of phase 8's decode too) and 128
# over 8 (16: two head chunks of flash_decode_write, one of flash_decode and
# paged_attention), bf16 and int8; then head_dim 256: Gemma-2-9B's 16 over
# 8 (a group of 2) and Gemma-2B's 8 over 1 (8: phase 3's head_dim-256 model)
DECODE_GROUPS = {
    # (pos, s_eff): pos 700 heads the entry (the shape of earlier runs); pos
    # 64 / s_eff 256 is phase 4's decode (64 tokens after a 24-token prompt),
    # pos 40 / s_eff 256 at 24 heads phase 8's (32 tokens after the same prompt)
    "flash_decode_write": [(32, 8, 128, ((700, 1024), (1900, 2048), (64, 256))),
                           (24, 8, 128, ((700, 1024), (40, 256))),
                           (128, 8, 128, ((700, 1024),)),
                           (16, 8, 256, ((700, 1024), (1900, 2048))),
                           (8, 1, 256, ((700, 1024),))],
    # (int8, s_eff)
    "flash_decode": [(32, 8, 128, ((False, 1024), (False, 2048), (True, 1024), (True, 2048))),
                     (24, 8, 128, ((False, 2048), (True, 2048))),
                     (128, 8, 128, ((False, 2048), (True, 2048))),
                     (16, 8, 256, ((False, 2048), (True, 2048))),
                     (8, 1, 256, ((False, 2048), (True, 2048)))],
    # (label, lengths, int8): 8 rows, and at 24 heads also the 4 rows of
    # phase 8's server (serve_four's prompts, 32 tokens into their answers)
    "paged_attention": [
        (32, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                      ("bf16, lengths 1..2048", [1, 63, 64, 65, 700, 1024, 1500, 2048], False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (24, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True),
                      ("bf16, phase 8's 4 served rows", [n + 32 for n in SERVE_LENGTHS],
                       False))),
        (128, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                       ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (16, 8, 256, (("bf16, every length 1024", [1024] * 8, False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (8, 1, 256, (("bf16, every length 1024", [1024] * 8, False),))],
}


def group_note(hq: int, hkv: int, most: int = 8) -> str:
    """The head group of a decode shape and the K/V reads of its chunks
    (chunks of up to `most` heads: attention.head_chunks)."""
    from llamafile_tpu_torch.ops.attention import head_chunks
    g = hq // hkv
    nc = head_chunks(g, most)
    return f"G={g}" + (f" in {nc} chunks, each reading the K/V rows" if nc > 1
                       else ", one K/V read" if g > 8 else "")


def paged_work(lengths, hq, hkv, hd, int8):
    """(bytes, operations, op rate) of paged_attention's bound: each visible
    K/V row read once (int8: its f32 scale too), q read and the output
    written in f32; the f32 flops of scores and P.V on the CUDA cores."""
    kv_bytes = sum(lengths) * hkv * hd * 2 * (1 + 4 / hd if int8 else 2)
    return (kv_bytes + 2 * len(lengths) * hq * hd * 4, 4 * sum(lengths) * hq * hd,
            F32_FLOP_PER_S)


def paged_yardstick(torch, q, kp, vp, ks, vs, lens, tables, nl):
    """The library yardstick of paged_attention, fn(i) on layer i of nl:
    sdpa over K/V gathered to dense [R, Hkv, S, D] bf16 beforehand (the
    gather, and an int8 pool's dequant, not timed) with a length mask; the
    G query heads of a KV head ride as G queries."""
    r, hq, hd = q.shape
    hkv, _, ps, _ = kp.shape[1:]
    maxp = tables.shape[1]
    t = tables.long()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def dense(pages, scales, i):
        x = pages[i][:, t]                                 # [Hkv, R, MAXP, ps, D]
        if scales is not None:
            x = x.float() * scales[i][:, t]
        return x.permute(1, 0, 2, 3, 4).reshape(r, hkv, maxp * ps, hd).to(torch.bfloat16)
    kd = [dense(kp, ks, i) for i in range(nl)]
    vd = [dense(vp, vs, i) for i in range(nl)]
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < lens[:, None].long())[:, None, None]
    qg = q.to(torch.bfloat16).reshape(r, hkv, hq // hkv, hd)
    return lambda i: sdpa(qg, kd[i], vd[i], attn_mask=mask, scale=1.0)


def prefill_work(t, hq, hkv, hd):
    """(bytes, operations, op rate) of flash_prefill's bound: q, k, v read
    and the output written once in bf16; the causal products' bf16 flops."""
    return (t * (hq + 2 * hkv) + t * hq) * hd * 2, 2 * hq * hd * t * (t + 1), BF16_FLOP_PER_S


def fdw_phase(torch, dev, gen, entry, sdpa, hq, cases, hkv=8, hd=128):
    """Phase 2 for flash_decode_write at hq query heads over hkv KV heads of
    head dim hd, at each (pos, s_eff) of cases: against its plain version
    within 2e-2 and with the written rows equal, two launches bitwise equal,
    timed beside its plain version and sdpa."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import FDW_CLUSTER, FDW_WARPS
    nl, s_len = 32, 2048
    scale = hd ** -0.5
    k3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(torch.bfloat16)
    v3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(torch.bfloat16)
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    kn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    vn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    chunks = A.head_chunks(hq // hkv)
    log(f"  flash_decode_write {group_note(hq, hkv)}: clusters of {FDW_CLUSTER} blocks, "
        f"{hkv * chunks * FDW_CLUSTER} blocks of {32 * FDW_WARPS} threads at B=1 Hkv={hkv}")
    for pos, s_eff in cases:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        k3b, v3b = k3.clone(), v3.clone()
        got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 5, p, scale, hkv, s_limit=s_eff)
        want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 5, p, scale, hkv, s_eff)
        torch.cuda.synchronize()
        err = check_close(f"flash_decode_write/pos={pos}", got, want, 2e-2)
        if not (torch.equal(k3, k3b) and torch.equal(v3, v3b)):
            raise AssertionError("flash_decode_write: the written cache rows differ")
        again = A.flash_decode_write_stacked(q, k3b, v3b, kn, vn, 5, p, scale, hkv,
                                             s_limit=s_eff)
        if not (torch.equal(again, got) and torch.equal(k3, k3b) and torch.equal(v3, v3b)):
            raise AssertionError("flash_decode_write: two launches on the same inputs differ")
        log(f"  flash_decode_write/pos={pos}: two launches bitwise equal")
        del k3b, v3b, again
        run = lambda i: A.flash_decode_write_stacked(q, k3, v3, kn, vn, i, p, scale, hkv,
                                                     s_limit=s_eff)
        ms = time_ms(torch, run, nl)
        plain = time_ms(torch, lambda i: A.flash_decode_write_plain(
            q, k3, v3, kn, vn, i, p, scale, hkv, s_eff), nl)
        qs4 = q.to(torch.bfloat16).reshape(1, hq, 1, hd)
        kv = lambda t, i: t[i, :, :pos + 1].reshape(1, pos + 1, hkv, hd).transpose(1, 2)
        lib = time_ms(torch, lambda i: sdpa(qs4, kv(k3, i), kv(v3, i), scale=scale,
                                            enable_gqa=True), nl)
        sdpa_out = sdpa(qs4, kv(k3, 5), kv(v3, 5), scale=scale, enable_gqa=True)
        check_close("flash_decode_write vs sdpa (yardstick sanity)",
                    got.reshape(1, hq, 1, hd), sdpa_out, 2e-2)
        log(f"  flash_decode_write/pos={pos}: kernel / sdpa {ms / lib:.3f}")
        row = hkv * hd
        entry("flash_decode_write", "llamafile_tpu_torch/csrc/flash_decode_write.cu",
              "llamafile_tpu/ops/attention.py:217",
              f"Hq={hq} Hkv={hkv} D={hd} s_eff={s_eff} pos={pos} cluster={FDW_CLUSTER}"
              + ("" if chunks == 1 else f" ({group_note(hq, hkv)}: the kernel reads "
                 f"{chunks}x the bound's K/V bytes)"), err, ms,
              plain, lib, 2 * pos * row * 2 + 2 * row * 2 + (2 * hq * hd + 2 * row) * 4,
              4 * pos * hq * hd, BF16_FLOP_PER_S)
    del k3, v3
    torch.cuda.empty_cache()


def flash_decode_phase(torch, dev, gen, entry, sdpa, hq, int8, s_eff, hkv=8, hd=128):
    """Phase 2 for flash_decode at hq query heads over hkv KV heads of head
    dim hd, over a bf16 flat or int8 cache of s_eff positions, pos near its
    end: row by row against its plain version, the controls (one masked key
    made visible, the second half of the visible keys dropped) outside the
    tolerance, two launches bitwise equal, timed beside its plain version
    and sdpa. One launch of B * Hkv * head_chunks(G, FD_CHUNK_HEADS)
    clusters, every K/V row read once a chunk."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    nl = 32
    scale = hd ** -0.5
    g = hq // hkv
    pos = s_eff - 5
    label = (f"{'int8 + f32 scales' if int8 else 'bf16 flat'}, s_eff={s_eff} pos={pos}"
             + ("" if g <= 8 else f", {group_note(hq, hkv, A.FD_CHUNK_HEADS)}"))
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    if int8:
        kc, vc = (torch.randint(-127, 128, (nl, 1, s_eff, hkv, hd), generator=gen,
                                device=dev, dtype=torch.int8) for _ in range(2))
        ksc, vsc = (torch.empty((nl, 1, s_eff, hkv), device=dev).uniform_(
            2e-3, 2e-2, generator=gen) for _ in range(2))
        run = lambda i, pp=p: A.flash_decode(q, kc[i], vc[i], pp, scale,
                                             k_scale=ksc[i], v_scale=vsc[i])
        plain_fn = lambda i, pp=p: A.flash_decode_plain(q, kc[i], vc[i], pp, scale,
                                                        k_scale=ksc[i], v_scale=vsc[i])
        kv_bytes = 2 * (pos + 1) * hkv * (hd + 4)
        tol = DECODE_INT8_ROW_TOL
    else:
        kc, vc = ((torch.randn((nl, 1, s_eff, hkv * hd), generator=gen, device=dev)
                   ).to(torch.bfloat16) for _ in range(2))
        run = lambda i, pp=p: A.flash_decode_stacked(q, kc, vc, i, pp, scale, hkv)
        plain_fn = lambda i, pp=p: A.flash_decode_stacked_plain(
            q, kc, vc, i, pp, scale, hkv, s_eff)
        kv_bytes = 2 * (pos + 1) * hkv * hd * 2
        tol = DECODE_BF16_ROW_TOL
    got, want = run(5), plain_fn(5)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row = row_rel_err(got, want)
    ctl = [row_rel_err(plain_fn(5, p + 1), want), row_rel_err(plain_fn(5, p // 2), want)]
    held = ctl if int8 else ctl[1:]       # bf16: one key moves less than p's rounding
    log(f"  flash_decode/{label}: max_abs_err {err:.6g}; per row {row:.6g} of the "
        f"row's max (tol {tol}); controls (one masked key visible, half the keys "
        f"dropped) {ctl[0]:.6g}, {ctl[1]:.6g}")
    if not row <= tol < min(held):
        raise AssertionError(f"flash_decode {label}: row error {row}, controls {ctl}")
    if not torch.equal(got, run(5)):
        raise AssertionError("flash_decode: two runs on the same inputs differ")
    ms = time_ms(torch, run, nl)
    plain = time_ms(torch, plain_fn, nl)
    # the library yardstick: sdpa over the visible K/V, dequantized to
    # f32 (int8) or kept bf16 beforehand (not timed)
    def dense(c, s, i):
        x = c[i, 0, :pos + 1].reshape(pos + 1, hkv, hd)
        x = x.float() * s[i, 0, :pos + 1][..., None] if s is not None else x
        return x.transpose(0, 1)[None]                     # [1, Hkv, S, D]
    kd = [dense(kc, ksc if int8 else None, i) for i in range(nl)]
    vd = [dense(vc, vsc if int8 else None, i) for i in range(nl)]
    qd = (q if int8 else q.to(torch.bfloat16)).reshape(1, hq, 1, hd)
    lib_fn = lambda i: sdpa(qd, kd[i], vd[i], scale=scale, enable_gqa=True)
    lib = time_ms(torch, lib_fn, nl)
    check_close(f"flash_decode/{label} vs sdpa (yardstick sanity)",
                got.reshape(1, hq, 1, hd), lib_fn(5), 2e-2)
    entry("flash_decode", "llamafile_tpu_torch/csrc/flash_decode.cu",
          "llamafile_tpu/ops/attention.py:117",
          f"B=1 Hq={hq} Hkv={hkv} D={hd} {label} (library: sdpa on K/V "
          "dequantized beforehand)", err, ms, plain, lib,
          kv_bytes + 2 * hq * hd * 4 + 4, 4 * (pos + 1) * hq * hd, F32_FLOP_PER_S)
    del kc, vc, kd, vd, got, want
    if int8:
        del ksc, vsc
    torch.cuda.empty_cache()


def paged_phase(torch, dev, gen, entry, sdpa, hq, label, lengths, int8, hkv=8, hd=128):
    """Phase 2 for paged_attention at hq query heads over hkv KV heads of
    head dim hd, a row
    for each of `lengths` over a pool of 32 layers (so the replays over layers spill
    the L2 as the fused step does), tables shuffled over the pool's pages:
    row by row against its plain version, the controls (one masked key made
    visible, each row's last page dropped) outside the tolerance, timed
    beside its plain version and sdpa."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import paged_case, paged_controls, row_rel_err
    nl, r, ps, maxp = 32, len(lengths), 64, 2048 // 64
    label = label + ("" if hq // hkv <= 8 else f", {group_note(hq, hkv, A.PA_CHUNK_HEADS)}")
    q, kp, vp, ks, vs, lens, tables = paged_case(
        gen, lengths, hq, hkv, hd, ps, maxp, n_layers=nl, int8=int8, device=dev)
    sc = (lambda t, i: None) if ks is None else (lambda t, i: t[i])
    lay = lambda i: (q, kp[i], vp[i], lens, tables, sc(ks, i), sc(vs, i))
    got = A.paged_attention(*lay(5))
    want = A.paged_attention_plain(*lay(5))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row = row_rel_err(got, want)
    ctl = [row_rel_err(c, want) for c in paged_controls(
        q, kp[5], vp[5], sc(ks, 5), sc(vs, 5), lens, tables, ps)]
    log(f"  paged_attention/{label}: max_abs_err {err:.6g}; per (row, head) "
        f"{row:.6g} of its max (tol {PAGED_ROW_TOL}); controls (one masked key "
        f"visible, last page dropped) {ctl[0]:.6g}, {ctl[1]:.6g}")
    if not row <= PAGED_ROW_TOL < min(ctl):
        raise AssertionError(f"paged_attention {label}: row error {row}, "
                             f"controls {ctl}")
    if not torch.equal(got, A.paged_attention(*lay(5))):
        raise AssertionError("paged_attention: two runs on the same inputs differ")
    ms = time_ms(torch, lambda i: A.paged_attention(*lay(i)), nl)
    plain = time_ms(torch, lambda i: A.paged_attention_plain(*lay(i)), nl)
    lib_fn = paged_yardstick(torch, q, kp, vp, ks, vs, lens, tables, nl)
    lib = time_ms(torch, lib_fn, nl)
    check_close(f"paged_attention/{label} vs sdpa (yardstick sanity)",
                got.reshape(r, hkv, hq // hkv, hd), lib_fn(5), 2e-2)
    entry("paged_attention", "llamafile_tpu_torch/csrc/paged_attention.cu",
          "llamafile_tpu/runtime/paged.py:277",
          f"R={r} Hq={hq} Hkv={hkv} D={hd} ps={ps} {label} (library: sdpa on "
          "K/V gathered beforehand, gather not timed)", err, ms, plain, lib,
          *paged_work(lengths, hq, hkv, hd, int8))
    del q, kp, vp, ks, vs, lib_fn, got, want
    torch.cuda.empty_cache()


def i8p_kernel_phase(torch, dev, gen, entry):
    """Phase 2 for the int8 prefill GEMM: llama3-8b's four products at M =
    1024 (a 1000-token prompt's bucket), gate|up at a ragged M = 300 (a
    300-row admission slice), then the four at M = 512 and 128 (the buckets
    of 257-512 and 33-128 tokens), each on layer 1 of a stack (the stacked
    form, row 16, by pointer), bitwise equal to its plain version, with a
    control (two blocks' weight scales swapped) that must fail I8P_TOL.
    Timed beside it: the plain version, the library yardstick torch._int_mm
    on the same codes without the per-block scales (which the port never
    calls), and qmm_dequant, the prefill GEMM without companions, at the
    same shape; at gate|up M = 1024 also the kernel on unrolled layers (one
    allocation each, row 15)."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import i8p_fault, rand_i8p, rand_q4b, rel_err
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, n, k, layers, ms_ in (("gate_up", 28672, 4096, 2, (1024, 300, 512, 128)),
                                     ("down", 4096, 14336, 3, (1024, 512, 128)),
                                     ("qkv", 6144, 4096, 8, (1024, 512, 128)),
                                     ("o", 4096, 4096, 12, (1024, 512, 128))):
        w8, sw = rand_i8p(gen, layers, n, k, dev)
        qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        for m in ms_:
            xq, sxa = Q.i8p_prep(torch.randn((m, k), generator=gen, device=dev))
            got = Q.qmm_i8p(xq, sxa, w8[1], sw[1])
            want = Q.qmm_i8p_plain(xq, sxa, w8[1], sw[1])
            torch.cuda.synchronize()
            bn = Q.i8p_tile_n(m, n, sms)
            what = f"qmm_i8p/{label}/M={m} (layer 1 of {layers}, n tile {bn})"
            err = check_close(what, got, want, I8P_TOL)
            ctl = rel_err(i8p_fault(xq, sxa, w8[1], sw[1]), want)
            same = torch.equal(got, want)
            log(f"  {what}: swapped-block-scales control {ctl:.6g} (must exceed {I8P_TOL}); "
                f"bitwise equal to the plain version: {same}")
            if not same:
                raise AssertionError(f"qmm_i8p {label} M={m}: not bitwise equal to the plain "
                                     "version")
            if not ctl > I8P_TOL:
                raise AssertionError(f"qmm_i8p {label}: the faulty control passes")
            del got, want
            ms = time_ms(torch, lambda i: Q.qmm_i8p(xq, sxa, w8[i], sw[i]), layers)
            plain = time_ms(torch, lambda i: Q.qmm_i8p_plain(xq, sxa, w8[i], sw[i]), layers)
            wt = [w8[i].t() for i in range(layers)]             # [K, N] views
            lib = time_ms(torch, lambda i: torch._int_mm(xq, wt[i]), layers)
            del wt
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            dq = time_ms(torch, lambda i: Q.qmm_dequant(xb, qs[i], sc[i]), layers)
            del xb
            log(f"  qmm_i8p/{label}/M={m}: qmm_dequant at the same shape {dq:.4f} ms "
                f"({dq / ms:.2f}x the int8 kernel's time)")
            nbytes = (n * k + (k // 256) * n * 4 + m * k + m * (k // 256) * 4 + 4 * m * n)
            if label == "gate_up" and m == 1024:
                # row 15: the same kernel on unrolled layers, one allocation each
                wu = [(w8[i].clone(), sw[i].clone()) for i in range(layers)]
                got_u = Q.qmm_i8p(xq, sxa, *wu[1])
                want_u = Q.qmm_i8p_plain(xq, sxa, *wu[1])
                torch.cuda.synchronize()
                err_u = check_close(f"qmm_i8p/{label}/M={m} (unrolled layer 1)", got_u,
                                    want_u, I8P_TOL)
                if not torch.equal(got_u, want_u):
                    raise AssertionError(f"qmm_i8p {label} M={m} unrolled: not bitwise equal "
                                         "to the plain version")
                log(f"  qmm_i8p/{label}/M={m} (unrolled layer 1): bitwise equal to the plain "
                    "version")
                del got_u, want_u
                un = time_ms(torch, lambda i: Q.qmm_i8p(xq, sxa, *wu[i]), layers)
                del wu
                entry("qmm_i8p", "llamafile_tpu_torch/csrc/qmm_i8p.cu",
                      "llamafile_tpu/ops/qmatmul.py:1808",
                      f"{label} M={m} N={n} K={k}, unrolled layers (n tile {bn}; library: "
                      f"torch._int_mm without the per-block scales; qmm_dequant {dq:.4f} ms)",
                      err_u, un, plain, lib, nbytes, 2 * m * n * k)
            entry("qmm_i8p", "llamafile_tpu_torch/csrc/qmm_i8p.cu",
                  "llamafile_tpu/ops/qmatmul.py:1904",
                  f"{label} M={m} N={n} K={k}, layer i of a stack of {layers} (n tile {bn}; "
                  f"library: torch._int_mm without the per-block scales; qmm_dequant "
                  f"{dq:.4f} ms)", err, ms, plain, lib, nbytes, 2 * m * n * k)
            del xq, sxa
        del w8, sw, qs, sc
        torch.cuda.empty_cache()


def int8_kernel_phase(torch, dev, gen, entry, dequant_bf16):
    """Phase 2 for the int8 flavour's q4b product: qmm_int8
    (rows 13-14) at M = 8 (a decode step, padded as qmatmul pads it) on layer
    i > 0 of a stack: gate|up, down, qkv, o, and the unstacked lm head; then
    gate|up and down at M = 32 (a 24-token prompt's bucket). Each against
    its plain version within 1e-5, a second launch bitwise equal, with a
    control (each superblock's lo and hi scale rows swapped) that must fail
    it, and timed beside its plain
    version, qmm_txn's library yardstick (torch.matmul on the weight
    dequantized to bf16 beforehand) and qmm_txn at the same shape; the
    bound is qs + scales + the activation codes and scales + y (the kernel
    reads no bias). Row 12, the planes kernel on a stacked layer, is
    measured with qmm_planes in kernel_phases."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import q4b_scale_swap, rand_q4b, rel_err
    for m, label, n, k, layers in ((8, "gate_up", 28672, 4096, 2),
                                   (8, "down", 4096, 14336, 3),
                                   (8, "qkv", 6144, 4096, 8),
                                   (8, "o", 4096, 4096, 12),
                                   (8, "lm_head", 129024, 4096, 1),
                                   (32, "gate_up", 28672, 4096, 2),
                                   (32, "down", 4096, 14336, 3)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        li = layers - 1
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        got = Q.qmm_int8(xq, sx, qs[li], sc[li])
        want = Q.qmm_int8_plain(xq, sx, qs[li], sc[li])
        torch.cuda.synchronize()
        where = f"layer {li} of {layers}" if layers > 1 else "unstacked"
        what = f"qmm_int8/{label}/M={m} ({where})"
        err = check_close(what, got, want, 1e-5)
        check_repeat(what, Q.qmm_int8(xq, sx, qs[li], sc[li]), got)
        ctl = rel_err(q4b_scale_swap(xq, sx, qs[li], sc[li]), want)
        log(f"  {what}: swapped-scale-rows control {ctl:.6g} (must exceed 1e-5)")
        if not ctl > 1e-5:
            raise AssertionError(f"qmm_int8 {label}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_int8(xq, sx, qs[i], sc[i]), layers)
        plain = time_ms(torch, lambda i: Q.qmm_int8_plain(xq, sx, qs[i], sc[i]), layers)
        txn = time_ms(torch, lambda i: Q.qmm_txn(xq, sx, qs[i], sc[i], b[i]), layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        log(f"  {what}: qmm_txn at the same shape {txn:.4f} ms ({txn / ms:.2f}x the int8 "
            "kernel's time)")
        entry("qmm_int8", "llamafile_tpu_torch/csrc/qmm_int8.cu",
              "llamafile_tpu/ops/qmatmul.py:224",
              f"{label} M={m} N={n} K={k}, {where} (qmm_txn {txn:.4f} ms)", err, ms, plain,
              lib, qs[0].numel() + sc[0].numel() * 2 + m * (k + k // 8) + 4 * m * n,
              2 * m * n * k)
        del qs, sc, b
        torch.cuda.empty_cache()


MOE_E, MOE_D, MOE_DFF = 8, 4096, 14336      # Mixtral-8x7B: top-2 of 8 experts
SWAP_CONTROL_MIN = 0.1     # a control with expert ids swapped must part this far


def swap_control(name, bad, want):
    from llamafile_tpu_torch.testing import rel_err
    ctl = rel_err(bad, want)
    log(f"  {name}: swapped-expert-ids control {ctl:.6g} (must exceed {SWAP_CONTROL_MIN})")
    if not ctl > SWAP_CONTROL_MIN:
        raise AssertionError(f"{name}: the control with swapped expert ids passes")


def moe_slots(torch, n_tok, seed):
    """Top-2 expert ids of n_tok tokens, distinct within a token: int64 [2 n_tok]."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(MOE_E, generator=g)[:2]
                        for _ in range(n_tok)]).reshape(-1)


def moe_kernel_phases(torch, dev, gen, entry, dequant_bf16):
    """Phase 2 for the MoE kernels at Mixtral-8x7B width (d 4096, d_ff 14336,
    8 experts): the routed fused FFN and the routed GEMVs at a decode step's
    2 slots, the grouped products at 8 serving rows (16 slots, tm 8), a
    256-token prompt (512 slots, tm 32) and a 1024-token prompt (2048 slots,
    tm 128), each against its plain version, with a control whose expert ids
    are swapped. Library: torch.bmm on the routed (or each tile's) experts
    dequantized to bf16 beforehand; none for the fused FFN."""
    from llamafile_tpu_torch.models.llama import group_layout
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b, rand_q8b
    E, d, dff = MOE_E, MOE_D, MOE_DFF
    gq, gs, gb = rand_q4b(gen, E, 2 * dff, d, dev)      # gate|up stacks (interleaved width)
    dq, ds, db = rand_q4b(gen, E, d, dff, dev)
    d8, d8s, _ = rand_q8b(gen, E, d, dff, 16, dev)      # Q4_K_M's Q6_K down stacks
    gu_e, dn_e = q4b_bytes(gq, gs, gb), q4b_bytes(dq, ds, db)
    d8_e = d8[0].numel() + d8s[0].numel() * 2
    pairs = [torch.tensor(p, dtype=torch.int32, device=dev) for p in ((0, 1), (2, 3), (4, 5),
                                                                     (6, 7))]
    ti = torch.zeros(2, dtype=torch.int32, device=dev)
    x1 = torch.randn((1, d), generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x1, 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
                                        1e-5)

    # --- qmm_moe_m1, routed: one launch pair for the decode step's 2 slots
    topw = torch.tensor([0.6, 0.4], device=dev)
    margs = lambda ei: (xq, sx, gq, gs, gb, dq, ds, db, ei, ti, topw)
    got, want = Q.qmm_moe_m1(*margs(pairs[0])), Q.qmm_moe_m1_plain(*margs(pairs[0]))
    torch.cuda.synchronize()
    err = check_close("qmm_moe_m1/routed S=2", got, want, 2e-3)
    check_repeat("qmm_moe_m1/routed S=2", Q.qmm_moe_m1(*margs(pairs[0])), got)
    swap_control("qmm_moe_m1/routed S=2", Q.qmm_moe_m1_plain(*margs(pairs[0].flip(0))), want)
    ms = time_ms(torch, lambda i: Q.qmm_moe_m1(*margs(pairs[i])), 4)
    plain = time_ms(torch, lambda i: Q.qmm_moe_m1_plain(*margs(pairs[i])), 4)
    entry("qmm_moe_m1", "llamafile_tpu_torch/csrc/qmm_moe_m1.cu",
          "llamafile_tpu/ops/qmatmul.py:1037",
          f"routed ffn S=2 of E={E} d={d} d_ff={dff} (2 distinct experts)", err, ms, plain,
          None, 2 * (gu_e + dn_e) + d + d // 8 + 4 * 2 * d, 2 * 2 * (2 * dff * d + d * dff))

    # --- the routed GEMVs: gate|up and down of a decode step's 2 slots ----
    def dq_all(qs, sc, b):
        return torch.stack([dequant_bf16(qs[e:e + 1], sc[e:e + 1], b[e:e + 1])[0]
                            if b is not None else Q.dequant_bf16(qs[e], sc[e])
                            for e in range(E)])
    for name, label, (qs, sc, b), k, ebytes in (
            ("qmm_txn_m1_r", "gate_up", (gq, gs, gb), d, gu_e),
            ("qmm_txn_m1_r", "down", (dq, ds, db), dff, dn_e),
            ("qmm_q8_m1_r", "down Q6_K", (d8, d8s, None), dff, d8_e)):
        fn, plain_fn = getattr(Q, name), getattr(Q, name + "_plain")
        n = qs.shape[-1]
        x = torch.randn((1, k), generator=gen, device=dev)
        rq, rs = Q.quantize_activations_g32(x)
        got, want = fn(rq, rs, qs, sc, b, pairs[0], ti), plain_fn(rq, rs, qs, sc, b, pairs[0], ti)
        torch.cuda.synchronize()
        err = check_close(f"{name}/{label} S=2", got, want, 1e-5)
        check_repeat(f"{name}/{label} S=2", fn(rq, rs, qs, sc, b, pairs[0], ti), got)
        swap_control(f"{name}/{label} S=2", plain_fn(rq, rs, qs, sc, b, pairs[0].flip(0), ti),
                     want)
        ms = time_ms(torch, lambda i: fn(rq, rs, qs, sc, b, pairs[i], ti), 4)
        plain = time_ms(torch, lambda i: plain_fn(rq, rs, qs, sc, b, pairs[i], ti), 4)
        w_all = dq_all(qs, sc, b)
        w2 = [w_all.index_select(0, pr) for pr in pairs]
        xb = x.to(torch.bfloat16).expand(2, 1, k).contiguous()
        lib = time_ms(torch, lambda i: torch.bmm(xb, w2[i]), 4)
        del w_all, w2
        entry(name, "llamafile_tpu_torch/csrc/qmm_routed.cu",
              "llamafile_tpu/ops/qmatmul.py:" + ("867" if name == "qmm_txn_m1_r" else "948"),
              f"{label} S=2 of E={E} N={n} K={k} (library: bmm on the 2 experts "
              "dequantized beforehand)", err, ms, plain, lib,
              2 * ebytes + k + k // 8 + 4 * 2 * n, 2 * 2 * n * k)
        torch.cuda.empty_cache()

    # --- the grouped products: serving at 8 rows, prompts of 256 and 1024 --
    for name, n_tok, tm in (("qmm_txn_g", 8, 8), ("qmm_txn_g", 256, 32),
                            ("qmm_planes_g", 1024, 128)):
        gid = moe_slots(torch, n_tok, n_tok).to(dev)
        order, pos, te, n_tiles = group_layout(gid, E, tm)
        te = te.to(torch.int32)
        n_exp = int(te.unique().numel())
        swapped = te.clone()
        j = int((te != te[0]).nonzero()[0, 0])          # the first tile of another expert
        swapped[0], swapped[j] = te[j], te[0]
        for label, (qs, sc, b), k, ebytes in (("gate_up", (gq, gs, gb), d, gu_e),
                                             ("down", (dq, ds, db), dff, dn_e)):
            n = qs.shape[-1]
            x = torch.zeros((n_tiles * tm, k), device=dev).index_copy_(
                0, pos, torch.randn((gid.shape[0], k), generator=gen, device=dev))
            if name == "qmm_txn_g":
                rq, rs = Q.quantize_activations_g32(x)
                run = lambda t: Q.qmm_txn_g(rq, rs, qs, sc, b, t, tm)
                plain_fn = lambda t: Q.qmm_txn_g_plain(rq, rs, qs, sc, b, t, tm)
                tol, rate, out_b = 1e-5, INT8_OPS_PER_S, 4
            else:
                run = lambda t: Q.qmm_planes_g(x, qs, sc, b, t)
                plain_fn = lambda t: Q.qmm_planes_g_plain(x, qs, sc, b, t)
                tol, rate, out_b = PLANES_BF16_TOL, BF16_FLOP_PER_S, 2
            got, want = run(te), plain_fn(te)
            torch.cuda.synchronize()
            what = f"{name}/{label} S={gid.shape[0]} tm={tm} ({n_tiles} tiles)"
            err = check_close(what, got, want, tol)
            if name == "qmm_txn_g":
                check_repeat(what, run(te), got)
            swap_control(what, plain_fn(swapped), want)
            del got, want
            ms = time_ms(torch, lambda i: run(te), 1)
            plain = time_ms(torch, lambda i: plain_fn(te), 1)
            wt = dq_all(qs, sc, b).index_select(0, te.long())      # each tile's expert
            xt = x.to(torch.bfloat16).reshape(n_tiles, tm, k)
            lib = time_ms(torch, lambda i: torch.bmm(xt, wt), 1)
            del wt, xt
            entry(name, f"llamafile_tpu_torch/csrc/{name}.cu",
                  "llamafile_tpu/ops/qmatmul.py:" + ("1373" if name == "qmm_txn_g" else "1432"),
                  f"{label} S={gid.shape[0]} tm={tm} {n_tiles} tiles of {n_exp} experts "
                  f"N={n} K={k} (library: bmm on each tile's expert dequantized beforehand)",
                  err, ms, plain, lib,
                  n_exp * ebytes + n_tiles * tm * (k + k // 8 if tm <= 32 else 2 * k)
                  + out_b * n_tiles * tm * n, 2 * n_tiles * tm * n * k, rate)
            torch.cuda.empty_cache()
    del gq, gs, gb, dq, ds, db, d8, d8s
    torch.cuda.empty_cache()


def _to(params, dev):
    """A copy of params on dev, stacked (one LlamaLayer) or unrolled (a list)."""
    import dataclasses
    from llamafile_tpu_torch.models.llama import LlamaParams
    mv = lambda v: (None if v is None else {k: q.to(dev) for k, q in v.items()}
                    if isinstance(v, dict) else v.to(dev))
    layer_to = lambda l: dataclasses.replace(l, **{
        f.name: mv(getattr(l, f.name)) for f in dataclasses.fields(l)})
    layers = ([layer_to(l) for l in params.layers] if isinstance(params.layers, list)
              else layer_to(params.layers))
    return LlamaParams(params.tok_embd.to(dev), layers, params.out_norm.to(dev),
                       params.output.to(dev))


@contextlib.contextmanager
def op_trace(rec):
    """While open, every product (qmatmul, qmatmul_moe and the MoE's routed
    and grouped products), activation
    quantization (its int8 codes) and attention call of the forward appends
    (label, output on the CPU, inputs) to the list rec[-1], in call order.
    Inputs are kept for the prefill, int8-cache decode and paged attention
    (on the CPU: the positional arguments, then a dict of the keyword ones)
    and for the products (x on the CPU, the other arguments as they are), so
    that each can be rerun on the other side's inputs; an int8 prefill
    product is kept twice, as qmatmul's call and as qmm_i8p's (its codes
    and scales). An activation quantization keeps its codes and scales as
    its inputs entry, for the rerun of the product it feeds. Nothing inside the
    fused FFN is kept: its plain version quantizes its hidden activations
    in torch, the kernel inside itself."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.runtime import paged as PG
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
                cpu = lambda t: t.cpu() if hasattr(t, "cpu") else t
                ins = ({"x": a[0].cpu(), "args": a[1:], "kw": kw} if keep_inputs == "call"
                       else tuple(t.cpu() for t in out) if keep_inputs == "out"
                       else [cpu(t) for t in a] + [{k: cpu(t) for k, t in kw.items()}]
                       if keep_inputs else None)
                rec[-1].append((label(*a, **kw), (out[0] if isinstance(out, tuple) else out).cpu(),
                                ins))
            return out
        if hasattr(fn, "launches"):
            # a kernel wrapper counts itself under its module name, which is
            # now `traced`: the count lives here until it is restored
            traced.launches = fn.launches
        setattr(mod, name, traced)
    wrap(LM, "qmatmul", lambda x, qt, li=None, *_, **_kw: f"product N={qt.shape[0]}"
         + ("" if li is None else f" layer {li}"), keep_inputs="call")
    wrap(LM, "qmatmul_moe", lambda x, gu, dn, ids, *_, **kw: f"fused ffn S={ids.shape[0]}",
         True, keep_inputs="call")
    wrap(LM, "qmatmul_routed", lambda x, qt, ids, *_, **kw:
         f"routed product N={qt.shape[0]} S={ids.shape[0]}", keep_inputs="call")
    wrap(LM, "qmatmul_grouped", lambda x, qt, te, *_, **kw:
         f"grouped product N={qt.shape[0]} rows={x.shape[0]} tm={kw['tm']}", keep_inputs="call")
    wrap(Q, "quantize_activations_g32",
         lambda x, *_, **_kw: f"codes M={x.shape[0]} K={x.shape[1]}", keep_inputs="out")
    wrap(Q, "i8p_prep", lambda x, *_, **_kw: f"i8p codes M={x.shape[0]} K={x.shape[1]}")
    wrap(Q, "qmm_i8p", lambda xq, sxa, w8, sw: f"i8p product M={xq.shape[0]} N={w8.shape[0]}",
         keep_inputs="call")
    wrap(LM, "flash_prefill", lambda *_, **_kw: "prefill attention", keep_inputs=True)
    wrap(LM, "flash_decode_write_stacked", lambda *a, **_kw: f"L{a[5]} decode attention")
    wrap(LM, "flash_decode", lambda *a, **kw: "int8 decode attention", keep_inputs=True)
    wrap(PG, "paged_attend", lambda *a, **kw: "paged attention", keep_inputs=True)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            if hasattr(fn, "launches"):
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)


def trace_report(steps_card, steps_cpu):
    """One line a forward call: where card and CPU first part, and how far.
    A quantization's int8 codes are compared code by code; every other
    output by max |diff| / max |CPU value|. Every product of the card is
    also rerun through its plain version on the CPU, on the card's own
    input (its activation codes and scales too, where the product made
    them) and the CPU's copy of the weights; a grouped product's plain
    version runs on the card (grouped_plain), where phase 2 holds the same
    comparison. Returns (lines, {route: the
    largest parting of a product from its plain version on the same
    inputs}) for the int8-activation GEMVs, qmm_txn and qmm_int8 ("int8"),
    the dequant GEMM and _routed_fallback ("dequant"), the two-plane GEMM
    ("planes"), the fused FFN ("ffn") and the int8 prefill ("i8p", held on
    the card's own int8 codes and scales: an activation code can flip
    between the two sides' RMSNorms): a fault in a product kernel shows
    there, whatever parted before it."""
    import torch
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rel_err
    lines, same = [], {"int8": 0.0, "dequant": 0.0, "planes": 0.0, "ffn": 0.0,
                       "planes_g": 0.0, "i8p": 0.0}
    for i, (card, cpu) in enumerate(zip(steps_card, steps_cpu)):
        n_q = flips = q_flipped = 0
        first, worst = None, (0.0, "")
        for j, ((lab, a, ia), (lab_b, b, ib)) in enumerate(zip(card, cpu)):
            assert lab == lab_b, (lab, lab_b)
            if isinstance(ia, dict) and lab.startswith("i8p product"):
                # the card's codes and scales, the CPU's copy of the weights
                same["i8p"] = max(same["i8p"], rel_err(a, Q.qmm_i8p_plain(
                    ia["x"], ia["args"][0].cpu(), *ib["args"][1:])))
            elif isinstance(ia, dict):           # a product: rerun plain on the card's x
                fn = (LM.qmatmul_moe if "fused ffn" in lab else LM.qmatmul_routed
                      if lab.startswith("routed") else LM.qmatmul_grouped
                      if lab.startswith("grouped") else LM.qmatmul)
                # the weights from the CPU's copy; expert ids, rows and routing
                # weights (tensors) from the card's call, as it routed
                pick = lambda c, h: c.cpu() if isinstance(c, torch.Tensor) else h
                args = [pick(c, h) for c, h in zip(ia["args"], ib["args"])]
                kw = {k: pick(ia["kw"][k], v) for k, v in ib["kw"].items()}
                # the product's own activation codes and scales, where it made
                # them (the call just before it): the host's RMSNorm and
                # rsqrt part from the card's by an ulp of a scale
                codes = card[j - 1][2] if j and card[j - 1][0].startswith("codes") else None
                # where the card's inputs equal the CPU's bit for bit, the
                # CPU's output is the plain version on them
                same_in = torch.equal(ia["x"], ib["x"]) and all(
                    torch.equal(c, h) for c, h in zip(args + list(kw.values()),
                                                      ib["args"] + tuple(ib["kw"].values()))
                    if isinstance(h, torch.Tensor)) and (codes is None or all(
                        torch.equal(c, h) for c, h in zip(codes, cpu[j - 1][2])))
                qt, m = ib["args"][0], ia["x"].shape[0]
                if "fused ffn" in lab:
                    route = "ffn"
                elif lab.startswith("routed"):     # the routed GEMVs, or _routed_fallback
                    route = ("int8" if qt.kind == "q8b" or (qt.kind == "q4b" and
                                                            Q.q4b_flavour() == "txn")
                             else "dequant")
                elif lab.startswith("grouped"):
                    route = "int8" if kw["tm"] <= 32 else "planes_g"
                else:                              # qmatmul's kernel under the flavour
                    li = ib["args"][1] if len(ib["args"]) > 1 else ib["kw"].get("li")
                    route = PRODUCT_CHECK.get(Q.product_route(qt, m, ia["x"].shape[1], li))
                if route:
                    want = (b if same_in else grouped_plain(Q, ia, codes)
                            if lab.startswith("grouped") else
                            with_codes(Q, codes, lambda: fn(ia["x"], *args, **kw)))
                    same[route] = max(same[route], rel_err(a, want))
            if not a.dtype.is_floating_point:
                n_q += 1
                nf = int((a != b).sum())
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
        lines.append(f"step {i}: {len(card)} calls; codes differ in {q_flipped} of {n_q} "
                     f"quantizations ({flips} codes); first parting (codes, or > 1e-4): "
                     f"{first}; largest {worst[0]:.3g} at {worst[1]}")
    return lines, same


def grouped_plain(Q, ia, codes):
    """The plain version of a grouped product (qmatmul_grouped's call ia) on
    the card, on the card's own x, activation codes and scales (codes, for
    tm <= 32), weights and tile experts; returned on the CPU. On the CPU
    these plain versions dequantize an expert's weights once a tile, the
    most of phase 3's CPU time at Mixtral width."""
    import torch
    qt, te = ia["args"][0], ia["args"][1].to(torch.int32)
    tm, dev = ia["kw"]["tm"], qt.qs.device
    if tm <= 32:
        xq, sx = (c.to(dev) for c in codes)
        y = Q.qmm_txn_g_plain(xq, sx, qt.qs, qt.scales, qt.bias, te, tm)
    else:
        y = Q.qmm_planes_g_plain(ia["x"].to(dev), qt.qs, qt.scales, qt.bias, te, tm)
    n = qt.shape[0]
    return (y[:, :n] if y.shape[1] > n else y).cpu()


# the limit (SAME_INPUT_TOL) that holds each kernel of qmatmul on the same
# inputs; qmm_i8p is held on its own codes (same["i8p"]), a dense product
# has no kernel
PRODUCT_CHECK = {"qmm_q8_m1": "int8", "qmm_txn_m1": "int8", "qmm_txn": "int8",
                 "qmm_int8": "int8", "qmm_planes": "planes", "qmm_dequant": "dequant"}


def with_codes(Q, codes, run):
    """run(), with its first activation quantization answered by `codes`
    (the card's (xq, sx) for the product being rerun), where there are any."""
    if codes is None:
        return run()
    orig, left = Q.quantize_activations_g32, [codes]
    Q.quantize_activations_g32 = lambda *a, **kw: left.pop() if left else orig(*a, **kw)
    try:
        return run()
    finally:
        Q.quantize_activations_g32 = orig


# phase 2's limits; planes: its bf16 output, then the bias term added in
# bf16, each a rounding of up to one bf16 step of the largest output
SAME_INPUT_TOL = {"int8": 1e-5, "dequant": 1e-3, "planes": 2 * PLANES_BF16_TOL,
                  "ffn": 2e-3, "planes_g": PLANES_BF16_TOL,     # planes_g: one rounding
                  "i8p": I8P_TOL}


def check_same_input(what, same):
    log(f"  {what} trace: each product against its plain version on the card's own "
        "inputs: " + ", ".join(f"{k} {v:.3g} (tol {SAME_INPUT_TOL[k]})"
                               for k, v in same.items()))
    bad = {k: v for k, v in same.items() if v > SAME_INPUT_TOL[k]}
    if bad:
        raise AssertionError(f"{what}: a product kernel parts from its plain version "
                             f"on the same inputs: {bad}")


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
        if lab != "prefill attention" or not A._use_flash(ins[0].shape[1],
                                                          ins[0].shape[3]):
            continue
        q, k, v, scale = ins[:4]
        on_card = [t.to(dev) for t in (q, k, v)]
        same = row_rel_err(A.flash_prefill(*on_card, scale),
                           A.flash_prefill_plain(*on_card, scale))
        part = (got - want).abs().amax(-1)[0]                   # [T, Hq]
        t, h = divmod(int(part.argmax()), part.shape[1])
        bf = lambda a: a.to(torch.bfloat16).float()
        s = bf(q[0, t, h]) @ bf(k[0, :t + 1, h // (q.shape[2] // k.shape[2])]).T * scale
        top = torch.topk(s, min(2, s.numel())).values.tolist() + [float("nan")]
        lines.append(f"call {j} {lab}: kernel vs plain on the card's inputs {same:.3g} "
                     f"per row (tol {FLASH_ROW_TOL}); card vs CPU part most at row {t} "
                     f"head {h} ({part[t, h].item() / want[0, t, h].abs().max().item():.3g} "
                     f"of its max), top-2 scores {top[0]:.6g}, {top[1]:.6g} (std "
                     f"{s.std().item():.4g})")
        if same > FLASH_ROW_TOL:
            raise AssertionError(f"flash_prefill on the path's inputs: {same}")
    return lines


def whole_path_check(torch, dev, quant="Q4_K", n_prompt=32, n_decode=8,
                     kv_dtype="bf16", i8p=False):
    """Two layers at llama3-8b width: card (kernels) vs CPU (plain versions).
    quant "Q4_K_M" is the Q4_K_M recipe at two layers (layer 1 holds the
    Q6_K V and down), unrolled; the others are stacked. i8p attaches the int8
    prefill companions first (models.llama.int8_prefill_params), as the
    Engine does under LLAMAFILE_TPU_I8P=1. The prompt is padded
    to its prefill bucket, as Engine.prefill does. Every op's output is kept
    on both sides, and trace_report's lines are logged: the op at which card
    and CPU first part in each step."""
    from llamafile_tpu_torch.models.llama import (forward, init_cache, int8_prefill_params,
                                                  stack_layers)
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.testing import make_q4_k_m_llama
    if quant == "Q4_K_M":
        cfg, params = make_q4_k_m_llama("llama3-8b-2l", seed=1, device=dev)
    else:
        cfg, params = make_synthetic_llama("llama3-8b-2l", quant, seed=1, fuse=True,
                                           device=dev)
    gpu = stack_layers(int8_prefill_params(params) if i8p else params)
    what = (f"{quant}{'' if kv_dtype == 'bf16' else ' ' + kv_dtype + ' KV'}"
            + (" int8 prefill" if i8p else "") + flavour_note())
    cpu = _to(gpu, "cpu")
    bucket = bucket_len(n_prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :n_prompt] = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                       generator=torch.Generator().manual_seed(2))
    max_len = max(256, bucket + n_decode)
    caches = {d: init_cache(cfg, 1, max_len, kv_dtype, device=d) for d in ("cuda", "cpu")}
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
    lines, same = trace_report(rec["cuda"], rec["cpu"])
    for line in lines:
        log(f"  {what} trace {line}")
    check_same_input(f"{what} prompt {n_prompt}", same)
    for line in prefill_attention_report(torch, dev, rec["cuda"][0], rec["cpu"][0]):
        log(f"  {what} trace {line}")
    for line in decode_attention_report(torch, dev, rec["cuda"]):
        log(f"  {what} trace {line}")
    del rec
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  {what} prompt {n_prompt} (bucket {bucket}) step {i}: top-1 card "
            f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"whole path {what} step {i}: card and CPU disagree")
    del gpu, cpu, params
    torch.cuda.empty_cache()


ROUTER_SAME_TOL = 1e-5      # router weights, card vs plain on the card's input


def router_report(torch, step_card, step_cpu, n_experts, k):
    """The router calls of one traced forward (dense products of N =
    n_experts): each rerun through its plain version on the card's own input,
    whose softmax weights must agree with the card's within ROUTER_SAME_TOL;
    a row whose top-k differs there is a fault unless the plain margin
    between the k-th and (k+1)-th weight is within twice that row's rounding
    (a tie). Then the card's and the CPU's choices row by row: a row that
    chose other experts there follows from an earlier parting of the two
    runs (each product is held on its own inputs). Returns (the rows routed
    otherwise on the two sides, the smallest CPU margin among them,
    same-input ties, the largest router rounding)."""
    from llamafile_tpu_torch.models import llama as LM
    swaps, min_margin, ties, rnd = set(), float("inf"), 0, 0.0
    for (lab, a, ia), (_, b, ib) in zip(step_card, step_cpu):
        if not isinstance(ia, dict) or lab.startswith(("routed", "grouped", "fused")):
            continue
        qt = ib["args"][0]
        if qt.kind != "dense" or qt.shape[0] != n_experts:
            continue
        plain = LM.qmatmul(ia["x"], *ib["args"], **ib["kw"])
        wc, wp, wh = (torch.softmax(t.float(), -1) for t in (a, plain, b))
        row_rnd = (wc - wp).abs().amax(-1)
        rnd = max(rnd, row_rnd.max().item())
        pick = lambda w: LM.top_k(w, k)[1].sort(-1).values
        sorted_p = wp.sort(-1, descending=True).values
        margin_p = sorted_p[:, k - 1] - sorted_p[:, k]
        for r in (pick(wc) != pick(wp)).any(-1).nonzero()[:, 0].tolist():
            if margin_p[r] > 2 * row_rnd[r]:
                raise AssertionError(f"{lab}: row {r} routed to other experts on the same "
                                     f"input (margin {margin_p[r]:.3g}, rounding "
                                     f"{row_rnd[r]:.3g})")
            ties += 1
        sorted_h = wh.sort(-1, descending=True).values
        margin_h = sorted_h[:, k - 1] - sorted_h[:, k]
        diff = (pick(wc) != pick(wh)).any(-1)
        swaps |= set(diff.nonzero()[:, 0].tolist())
        if diff.any():
            min_margin = min(min_margin, margin_h[diff].min().item())
    if rnd > ROUTER_SAME_TOL:
        raise AssertionError(f"router weights part from the plain version on the card's "
                             f"input by {rnd}")
    return swaps, min_margin, ties, rnd


@contextlib.contextmanager
def no_sync_moe(torch):
    """While open, every moe_ffn call runs under
    torch.cuda.set_sync_debug_mode("error"): a call that reads a device value
    on the host (a sync) raises. Yields a list whose length counts the calls."""
    from llamafile_tpu_torch.models import llama as LM
    orig, calls = LM.moe_ffn, []

    def strict(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(a[0].shape[0])
        return out
    LM.moe_ffn = strict
    try:
        yield calls
    finally:
        LM.moe_ffn = orig


def moe_path_check(torch, dev, quant="Q4_K", runs=((24, 4), (300, 0)),
                   preset="mixtral-8x7b-2l"):
    """Layers at Mixtral-8x7B width (preset), card (kernels) against the CPU
    (plain versions). quant "Q4_K" is stacked ([L*E] expert stacks: the
    grouped kernels at prefill, the routed fused FFN at decode); "Q4_K_M" is
    the recipe at two layers (layer 1's experts with Q6_K down: the routed
    GEMVs at decode and the dense expert loop at prefill; attn_k/v Q8_0,
    attn_output Q5_K), unrolled. Each run prefills its prompt (padded to its
    bucket) on both sides, then decodes teacher-forced with the card's
    greedy token, each step from the card's cache. Every product is rerun
    through its plain version on the card's own inputs and expert ids; the
    routers as router_report holds them; the logits of a step within 2e-2
    with the same top-1 where no row chose other experts on the two sides,
    and reported otherwise. Then one more decode step with every MoE FFN
    call under the sync check."""
    from llamafile_tpu_torch.models.llama import forward, init_cache, stack_layers
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.testing import make_q4_k_m_llama
    if quant == "Q4_K_M":
        cfg, params = make_q4_k_m_llama(preset, seed=1, device=dev)
    else:
        cfg, params = make_synthetic_llama(preset, quant, seed=1, fuse=True,
                                           device=dev)
    gpu = stack_layers(params)
    what = (f"Mixtral {quant} ({'stacked' if not isinstance(gpu.layers, list) else 'unrolled'}"
            f"{flavour_note()})")
    cpu = _to(gpu, "cpu")
    from llamafile_tpu_torch.ops import qmatmul as Q
    # the decode steps' routed products (gate|up, down a layer, both sides)
    # leave the routed GEMVs for _routed_fallback where the q4b experts are
    # outside the txn flavour
    fallback = quant == "Q4_K" and Q.q4b_flavour() != "txn"
    total_swaps = 0
    for n_prompt, n_decode in runs:
        Q.ROUTE_COUNTS["routed_fallback"] = 0
        bucket = bucket_len(n_prompt)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n_prompt] = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                           generator=torch.Generator().manual_seed(n_prompt))
        max_len = bucket + n_decode + 1
        caches = {d: init_cache(cfg, 1, max_len, device=d) for d in ("cuda", "cpu")}
        rec = {"cuda": [], "cpu": []}
        logits = {"cuda": [], "cpu": []}

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
            for name in ("k", "v"):
                getattr(caches["cpu"], name).copy_(getattr(caches["cuda"], name))
            for d, p in (("cuda", gpu), ("cpu", cpu)):
                run(d, p, torch.tensor([[nxt]]), n_prompt + step, attn_len=max_len)
            nxt = int(logits["cuda"][-1].argmax())
        want_fb = 2 * 2 * cfg.n_layers * n_decode if fallback else 0
        log(f"  {what}: {Q.ROUTE_COUNTS['routed_fallback']} _routed_fallback calls over both "
            f"sides' decode steps (expected {want_fb})")
        if Q.ROUTE_COUNTS["routed_fallback"] != want_fb:
            raise AssertionError(f"{what}: the routed products took another route")
        lines, same = trace_report(rec["cuda"], rec["cpu"])
        for line in lines:
            log(f"  {what} trace {line}")
        check_same_input(f"{what} prompt {n_prompt}", same)
        bad = []
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            swaps, margin, ties, rnd = router_report(torch, rec["cuda"][i], rec["cpu"][i],
                                                     cfg.n_experts, cfg.n_experts_used)
            total_swaps += len(swaps)
            rel = ((a - b).abs().max() / b.abs().max()).item()
            held = not swaps
            log(f"  {what} prompt {n_prompt} (bucket {bucket}) step {i}: top-1 card "
                f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = "
                f"{rel:.3g}; routers: card vs plain on its input {rnd:.3g} ({ties} ties), "
                f"{len(swaps)} rows routed otherwise than on the CPU"
                + (f" (smallest CPU margin {margin:.3g}): logits not held" if not held else ""))
            if held and (int(a.argmax()) != int(b.argmax()) or rel > 2e-2):
                bad.append(f"prompt {n_prompt} step {i}")
        if bad:
            raise AssertionError(f"{what}: card and CPU disagree at {bad}")
        del rec
        if n_decode:
            with no_sync_moe(torch) as calls:
                forward(gpu, cfg, torch.tensor([[nxt]], device=dev),
                        torch.tensor([n_prompt + n_decode], dtype=torch.int32, device=dev),
                        caches["cuda"], attn_len=max_len)
                torch.cuda.synchronize()
            log(f"  {what}: {len(calls)} MoE FFN calls of a decode step ran under "
                "set_sync_debug_mode('error'): no device sync")
    log(f"  {what}: {total_swaps} router rows chose other experts on the card than on "
        "the CPU over the traced steps")
    del gpu, cpu, params
    torch.cuda.empty_cache()


def decode_attention_report(torch, dev, steps):
    """Each int8-cache decode attention call of a traced run (flash_decode)
    rerun through the kernel and its plain version on the card's own inputs:
    within DECODE_INT8_ROW_TOL per row."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    worst, n = 0.0, 0
    for step in steps:
        for lab, _, ins in step:
            if lab != "int8 decode attention":
                continue
            q, k, v, pos, scale = [t.to(dev) if hasattr(t, "to") else t for t in ins[:5]]
            kw = {name: t.to(dev) for name, t in ins[5].items()}
            worst = max(worst, row_rel_err(A.flash_decode(q, k, v, pos, scale, **kw),
                                           A.flash_decode_plain(q, k, v, pos, scale, **kw)))
            n += 1
    if n and worst > DECODE_INT8_ROW_TOL:
        raise AssertionError(f"flash_decode on the path's inputs: {worst}")
    return [f"{n} int8 decode attention calls: kernel vs plain on the card's inputs "
            f"{worst:.3g} per row (tol {DECODE_INT8_ROW_TOL})"] if n else []


def paged_path_check(torch, dev, prompts=(24, 64, 200, 300), n_decode=4,
                     preset="llama3-8b-2l"):
    """The serving decode at two layers of llama3-8b width, card (kernels)
    against the same model on the CPU (plain versions): 4 rows admitted at
    `prompts` tokens (a dense row prefill each on the card, copied into a
    paged pool with shuffled page ids), then n_decode steps of
    forward_paged_decode over all rows, teacher-forced with the card's
    greedy tokens. Both sides start each step from the card's pool, so a
    step's parting is that step's own (the prefill's is phase 3's other
    checks'). Logits per row within 2e-2 of the largest with the same
    top-1; each paged attention call of the card's trace rerun through the
    kernel and its plain version on its own inputs, within PAGED_ROW_TOL.
    A MoE preset (Mixtral width) also holds its routers (router_report: a
    row routed otherwise on the two sides is reported, its logits not
    held), and runs one more step with every MoE FFN call under the sync
    check."""
    from llamafile_tpu_torch.models.llama import (forward, forward_paged_decode,
                                                  init_cache, stack_layers)
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.runtime.paged import PageAllocator, copy_row_to_pages, init_paged
    from llamafile_tpu_torch.testing import paged_controls, row_rel_err
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    gpu = stack_layers(params)
    cpu = _to(gpu, "cpu")
    r, ps, max_len = len(prompts), 64, 512
    what = f"paged {preset} {r} rows{flavour_note()}"
    maxp = max_len // ps
    n_pages = 1 + r * maxp
    alloc = PageAllocator(n_pages, ps, r, max_len)
    alloc.free = [int(p) for p in torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(5)) + 1]
    for i, n in enumerate(prompts):
        alloc.ensure(i, n + n_decode + 1)
    tables = {d: alloc.device_tables(r, device=d) for d in ("cuda", "cpu")}
    pools = {d: init_paged(cfg.n_layers, cfg.n_kv_heads, n_pages, ps, cfg.head_dim,
                           device=d) for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(6)
    last = []
    for i, n in enumerate(prompts):
        toks = torch.zeros((1, bucket_len(n)), dtype=torch.int64)
        toks[0, :n] = torch.randint(3, cfg.n_vocab, (n,), generator=gen)
        rc = init_cache(cfg, 1, max_len, device=dev)
        lg, _ = forward(gpu, cfg, toks.to(dev), torch.zeros(1, dtype=torch.int32, device=dev),
                        rc, fresh_prefill=True, last_idx=torch.tensor([n - 1], device=dev))
        copy_row_to_pages(pools["cuda"], rc.k, rc.v,
                          torch.tensor(alloc.tables[i], dtype=torch.int32), ps)
        last.append(int(lg[0, 0].argmax()))
    tok = torch.tensor(last, dtype=torch.int32)
    pos = torch.tensor(prompts, dtype=torch.int32)
    rec = {"cuda": [], "cpu": []}
    worst, bad = 0.0, []
    for step in range(n_decode):
        out = {}
        for name in ("k_pages", "v_pages"):
            getattr(pools["cpu"], name).copy_(getattr(pools["cuda"], name))
        for d, p in (("cuda", gpu), ("cpu", cpu)):
            rec[d].append([])
            with op_trace(rec[d]):
                lg, _ = forward_paged_decode(p, cfg, tok.to(d), (pos + step).to(d),
                                             pools[d], tables[d])
            out[d] = lg.float().cpu()
        a, b = out["cuda"], out["cpu"]
        swapped = set()
        if cfg.n_experts:
            swapped, margin, ties, rnd = router_report(torch, rec["cuda"][-1], rec["cpu"][-1],
                                                       cfg.n_experts, cfg.n_experts_used)
            log(f"  {what} step {step}: routers card vs plain on its input {rnd:.3g} "
                f"({ties} ties); rows routed otherwise than on the CPU {sorted(swapped)}")
        for i in range(r):
            rel = ((a[i] - b[i]).abs().max() / b[i].abs().max()).item()
            if i not in swapped:
                worst = max(worst, rel)
            log(f"  {what} step {step} row {i} (prompt {prompts[i]}): top-1 card "
                f"{int(a[i].argmax())} cpu {int(b[i].argmax())}, max |diff| / max |logit| "
                f"= {rel:.3g}" + (" (routed otherwise: not held)" if i in swapped else ""))
            if i not in swapped and (int(a[i].argmax()) != int(b[i].argmax()) or rel > 2e-2):
                bad.append(f"step {step} row {i}")
        tok = a.argmax(-1).to(torch.int32)
    lines, same = trace_report(rec["cuda"], rec["cpu"])
    for line in lines:
        log(f"  {what} trace {line}")
    check_same_input(what, same)
    if cfg.n_experts:
        with no_sync_moe(torch) as calls:
            forward_paged_decode(gpu, cfg, tok.to(dev), (pos + n_decode).to(dev),
                                 pools["cuda"], tables["cuda"])
            torch.cuda.synchronize()
        log(f"  {what}: {len(calls)} MoE FFN calls of a decode step ran under "
            "set_sync_debug_mode('error'): no device sync")
    same, ctl = 0.0, float("inf")
    for step in rec["cuda"]:
        for lab, _, ins in step:
            if lab != "paged attention":
                continue
            q, kp, vp, lens, tbl = [t.to(dev) for t in ins[:5]]
            want = A.paged_attention_plain(q, kp, vp, lens, tbl)
            same = max(same, row_rel_err(A.paged_attention(q, kp, vp, lens, tbl), want))
            ctl = min([ctl] + [row_rel_err(c, want) for c in
                               paged_controls(q, kp, vp, None, None, lens, tbl, ps)])
    log(f"  paged attention on the path's own inputs: kernel vs plain {same:.3g} per "
        f"(row, head) (tol {PAGED_PATH_TOL}); the controls there {ctl:.3g} at least "
        f"(not held: near one-hot softmax); logits card vs CPU at most {worst:.3g}")
    if same > PAGED_PATH_TOL:
        raise AssertionError(f"paged_attention on the path's inputs: {same}")
    if bad:
        raise AssertionError(f"{what}: card and CPU disagree at {bad}")
    del rec, gpu, cpu, params, pools
    torch.cuda.empty_cache()


def head_dim_64_check(torch, dev, n_prompt=40, n_decode=4, max_seq_len=1000):
    """Decode attention on the reference's non-kernel routes, at TinyLlama's
    widths at two layers (tinyllama-1.1b-2l: head_dim 64, 32 heads on 4 KV
    heads, d_ff 5632) with a max_seq_len that is not a multiple of 256. The
    Engine's prefill of an n_prompt-token prompt and n_decode decode steps
    over its bf16 cache (teacher-forced with the card's greedy token), card
    against CPU: logits within 2e-2 of the largest with the same top-1. Then,
    on the card, Engine.generate of 8 greedy tokens and 3 requests served at
    once by a 3-row batcher: every decode attention call takes the einsum
    (dense cache) or the gather (paged pool) route, counted exactly, and no
    decode kernel launches. Then the 3-row paged decode card against CPU
    (paged_path_check). Returns nothing; raises on any parting."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.server.batcher import Batcher
    preset = "tinyllama-1.1b-2l"
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    n = cfg.n_layers
    engs = {"cuda": Engine(cfg, params, Tokenizer({}), max_seq_len=max_seq_len, device=dev)}
    engs["cpu"] = Engine(cfg, _to(engs["cuda"].params, "cpu"), Tokenizer({}),
                         max_seq_len=max_seq_len, device="cpu")
    del params
    what = f"{preset} (head_dim {cfg.head_dim}, max_seq_len {max_seq_len})"
    prompt = torch.randint(3, cfg.n_vocab, (300,),
                           generator=torch.Generator().manual_seed(11)).tolist()
    caches = {d: e.new_cache() for d, e in engs.items()}
    logits = {d: [e.prefill(caches[d], prompt[:n_prompt])[0].float().cpu()]
              for d, e in engs.items()}
    nxt = int(logits["cuda"][0].argmax())
    for step in range(n_decode):
        for d, e in engs.items():
            lg, _ = forward(e.params, cfg, torch.tensor([[nxt]], device=d),
                            torch.tensor([n_prompt + step], dtype=torch.int32, device=d),
                            caches[d], attn_len=max_seq_len)
            logits[d].append(lg[0, -1].float().cpu())
        nxt = int(logits["cuda"][-1].argmax())
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  {what} prompt {n_prompt} {'prefill' if i == 0 else f'decode step {i}'}: "
            f"top-1 card {int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| "
            f"= {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"{what} step {i}: card and CPU disagree")
    del engs["cpu"], caches
    eng = engs["cuda"]
    sp = SamplingParams(temperature=0.0)
    decode_kernels = (A.flash_decode_write_stacked, A.flash_decode, A.paged_attention)

    def tallies():
        return dict(A.ROUTE_COUNTS), {w.__name__: w.launches for w in decode_kernels}
    reset_launch_counts()
    toks = [t for t, _ in eng.generate("", max_tokens=8, sampling=sp, stop_on_eog=False,
                                       prompt_ids=prompt[:n_prompt])]
    torch.cuda.synchronize()
    routes, launched = tallies()
    log(f"  {what} Engine.generate of {len(toks)} tokens: routes {routes}, decode kernel "
        f"launches {launched} (expected einsum {7 * n}, none launched)")
    if routes != {"einsum": 7 * n, "gather": 0} or any(launched.values()):
        raise AssertionError(f"{what}: Engine decode left the einsum route")
    reset_launch_counts()
    bt = Batcher(eng, rows=3)
    try:
        st0 = bt.stats["decode_steps"]
        reqs = [bt.submit(prompt[:k], sp, 6) for k in (24, 64, 300)]
        outs = []
        for r in reqs:
            got = []
            while True:
                kind, val = r.out.get(timeout=600)
                if kind == "error":
                    raise AssertionError(f"{what} batcher: {val}")
                if kind == "done":
                    break
                got.append(val)
            outs.append(got)
        steps = bt.stats["decode_steps"] - st0
    finally:
        bt.shutdown()
    routes, launched = tallies()
    log(f"  {what} batcher, 3 rows (prompts 24, 64, 300): {[len(o) for o in outs]} tokens, "
        f"{steps} paged decode steps; routes {routes}, decode kernel launches {launched} "
        f"(expected gather {n * steps}, none launched)")
    if [len(o) for o in outs] != [6] * 3 or routes["gather"] != n * steps \
            or any(launched.values()):
        raise AssertionError(f"{what}: the batcher's decode left the gather route")
    del engs, eng, bt
    torch.cuda.empty_cache()
    reset_launch_counts()
    paged_path_check(torch, dev, prompts=(24, 64, 300), preset=preset)
    if A.paged_attention.launches:
        raise AssertionError(f"{what}: the paged decode launched the paged kernel")
    log(f"  {what} paged decode card vs CPU: gather route {A.ROUTE_COUNTS['gather']} "
        "calls (both sides), no paged kernel launch")


def decode_model_check(torch, dev, preset="llama3.2-3b-2l", n_decode=4, max_seq_len=1024,
                       paged_prompts=(24, 64, 200, 300)):
    """Decode attention at a head group of 3 (llama3.2-3b-2l: Llama-3.2-3B's
    widths at two layers, 24 query heads over 8 KV heads, head_dim 128) or
    at head_dim 256 (gemma-2b-widths-2l: 8 over 1, a group of 8), Q4_K,
    fused and stacked. The Engine's prefill (a 300-token prompt over
    its bf16 cache, bucket 512: the dequant GEMM and the flash prefill; a
    40-token one over its stacked int8 cache) and n_decode decode steps
    (teacher-forced with the card's greedy token), card against CPU: logits
    within 2e-2 of the largest with the same top-1, each decode step on the
    card launching its decode kernel once a layer (flash_decode_write for
    bf16, flash_decode for int8) with no einsum step. Then, on the card,
    Engine.generate of 8 greedy tokens and 4 requests served at once by a
    4-row batcher, every decode attention call a kernel launch, counted
    exactly, with no einsum or gather step; then the paged decode of rows at
    paged_prompts, card against CPU (paged_path_check)."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.server.batcher import Batcher
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    n = cfg.n_layers
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=max_seq_len, device=dev)
    del params
    cpu_params = _to(eng.params, "cpu")
    what = f"{preset} (G = {cfg.n_heads // cfg.n_kv_heads}, D = {cfg.head_dim})"
    prompt = torch.randint(3, cfg.n_vocab, (300,),
                           generator=torch.Generator().manual_seed(12)).tolist()
    decode_kernel = {"bf16": A.flash_decode_write_stacked, "int8": A.flash_decode}
    for kv, n_prompt in (("bf16", 300), ("int8", 40)):
        engs = {d: Engine(cfg, p, Tokenizer({}), max_seq_len=max_seq_len, kv_dtype=kv,
                          device=d) for d, p in (("cuda", eng.params), ("cpu", cpu_params))}
        caches = {d: e.new_cache() for d, e in engs.items()}
        logits = {d: [e.prefill(caches[d], prompt[:n_prompt])[0].float().cpu()]
                  for d, e in engs.items()}
        nxt = int(logits["cuda"][0].argmax())
        torch.cuda.synchronize()
        reset_launch_counts()
        for step in range(n_decode):
            for d, e in engs.items():
                lg, _ = forward(e.params, cfg, torch.tensor([[nxt]], device=d),
                                torch.tensor([n_prompt + step], dtype=torch.int32, device=d),
                                caches[d], attn_len=max_seq_len)
                logits[d].append(lg[0, -1].float().cpu())
            nxt = int(logits["cuda"][-1].argmax())
        launched, routes = decode_kernel[kv].launches, dict(A.ROUTE_COUNTS)
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            log(f"  {what} {kv} KV, prompt {n_prompt} "
                f"{'prefill' if i == 0 else f'decode step {i}'}: top-1 card "
                f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = {rel:.3g}")
            if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
                raise AssertionError(f"{what} {kv} KV step {i}: card and CPU disagree")
        log(f"  {what} {kv} KV: {n_decode} decode steps on the card launched "
            f"{decode_kernel[kv].__name__} {launched} times (expected {n * n_decode}); "
            f"routes {routes}")
        if launched != n * n_decode or any(routes.values()):
            raise AssertionError(f"{what} {kv} KV: decode left the kernel route")
        del engs, caches
    del cpu_params
    sp = SamplingParams(temperature=0.0)
    reset_launch_counts()
    toks = [t for t, _ in eng.generate("", max_tokens=8, sampling=sp, stop_on_eog=False,
                                       prompt_ids=prompt[:24])]
    torch.cuda.synchronize()
    counts, routes = launch_counts(), dict(A.ROUTE_COUNTS)
    log(f"  {what} Engine.generate of {len(toks)} tokens: flash_decode_write launches "
        f"{counts['flash_decode_write_stacked']} (expected {7 * n}), routes {routes}")
    if counts["flash_decode_write_stacked"] != 7 * n or any(routes.values()):
        raise AssertionError(f"{what}: Engine decode left the kernel route")
    reset_launch_counts()
    bt = Batcher(eng, rows=4)
    try:
        st0 = bt.stats["decode_steps"]
        reqs = [bt.submit(prompt[:k], sp, 6) for k in (24, 64, 200, 300)]
        outs = []
        for r in reqs:
            got = []
            while True:
                kind, val = r.out.get(timeout=600)
                if kind == "error":
                    raise AssertionError(f"{what} batcher: {val}")
                if kind == "done":
                    break
                got.append(val)
            outs.append(got)
        steps = bt.stats["decode_steps"] - st0
    finally:
        bt.shutdown()
    counts, routes = launch_counts(), dict(A.ROUTE_COUNTS)
    log(f"  {what} batcher, 4 rows (prompts 24, 64, 200, 300): {[len(o) for o in outs]} "
        f"tokens, {steps} paged decode steps; paged_attention launches "
        f"{counts['paged_attention']} (expected {n * steps}), routes {routes}")
    if [len(o) for o in outs] != [6] * 4 or counts["paged_attention"] != n * steps \
            or any(routes.values()):
        raise AssertionError(f"{what}: the batcher's decode left the kernel route")
    del eng, bt
    torch.cuda.empty_cache()
    paged_path_check(torch, dev, prompts=paged_prompts, n_decode=n_decode, preset=preset)


def counted_generate(torch, eng, prompt, n_new):
    """One greedy Engine.generate of n_new tokens after a warm-up run (first
    launches of each kernel at these shapes, allocator; not counted), with
    every launch count set to 0 just before and read just after. Returns
    (tokens, counts, time to first token s, decode s after the first)."""
    from llamafile_tpu_torch.ops import reset_launch_counts
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
    counts = launch_counts()
    if len(toks) != n_new or any(t < 0 or t >= eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"generate produced {toks}")
    return toks, counts, t_first - t0, t_end - t_first


def launch_counts():
    """Every kernel wrapper's launch count by name, and qmm_planes' launches
    on a stacked layer's view (row 12) apart as "qmm_planes_stacked"."""
    from llamafile_tpu_torch.ops import kernel_wrappers
    from llamafile_tpu_torch.ops.qmatmul import qmm_planes
    return {**{w.__name__: w.launches for w in kernel_wrappers()},
            "qmm_planes_stacked": qmm_planes.stacked_launches}


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


def build_engine(torch, dev, quant, i8p=False):
    """Phase 4's engine: llama3-8b, 32 layers, fused, stacked; with i8p, built
    under LLAMAFILE_TPU_I8P=1 (companions attached before stacking)."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3-8b", quant, seed=0, fuse=True, device=dev)
    os.environ["LLAMAFILE_TPU_I8P"] = "1" if i8p else "0"
    try:
        eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    finally:
        del os.environ["LLAMAFILE_TPU_I8P"]
    del params
    torch.cuda.synchronize()
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b {quant}{' with int8 prefill companions' if i8p else ''} (32 "
        f"layers, fused, stacked) in {time.time() - t0:.1f} s; decode reads "
        f"{read / 1e9:.3f} GB of weights a step")
    return eng, read


def i8p_phase(torch, dev, prompt, long_prompt, n_new):
    """Phase 4e: phase 4's model (llama3-8b Q4_K, the same seed, fused,
    stacked) built under LLAMAFILE_TPU_I8P=1: Engine.generate of n_new greedy
    tokens from the 24-token prompt (bucket 32: qmm_txn, no companion read;
    decode as phase 4), then the 1000-token prompt's TTFT, median of 3, with
    one qmm_i8p launch a product of a layer's fused form (qkv, o, gate|up,
    down). Launches exact; the companions' bytes and the peak device memory.
    Returns the counted runs' counts."""
    from llamafile_tpu_torch.models.llama import I8P_FIELDS
    from llamafile_tpu_torch.ops.repack import I8PQTensor
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng, read = build_engine(torch, dev, "Q4_K", i8p=True)
    n = eng.cfg.n_layers
    leaves = [q for q in (getattr(eng.params.layers, f) for f in I8P_FIELDS)
              if isinstance(q, I8PQTensor)]
    comp = sum(t.numel() * t.element_size() for q in leaves for t in (q.qs8, q.s8))
    base = sum(q.nbytes for q in leaves)
    log(f"  companions on {len(leaves)} stacked leaves: {comp / 1e9:.3f} GB (their base "
        f"weights {base / 1e9:.3f} GB); device memory held before building "
        f"{held / 1e9:.2f} GB, peak while building "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, held after "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n,
                          "qmm_moe_m1": 64 * steps,
                          "flash_decode_write_stacked": n * steps}, "phase 4e")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_i8p": 4 * n, "flash_prefill": n, "qmm_txn_m1": 1},
                     "phase 4e, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt, int8 prefill: "
        f"{statistics.median(ttfts):.2f} ms (median of {', '.join(f'{t:.2f}' for t in ttfts)} "
        f"ms); peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, leaves
    torch.cuda.empty_cache()
    return [counts, counts_b]


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

    phase("phase 4b: the same engine, a 1000-token prompt (bucket 1024)")
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
    phase("phase 4d: the same stacked Q4_K weights, dense int8 KV cache, Engine.generate")
    from llamafile_tpu_torch.runtime.engine import Engine
    eng8 = Engine(eng.cfg, eng.params, eng.tokenizer, max_seq_len=2048, kv_dtype="int8",
                  device=dev)
    _, counts_d, ttft, decode_s = counted_generate(torch, eng8, prompt, n_new)
    check_counts(counts_d, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n_layers,
                            "qmm_moe_m1": 64 * steps, "flash_decode": n_layers * steps},
                 "phase 4d")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32, int8 KV")
    del eng8
    phase("phase 5: serving, the port's HTTP server over the same engine, 8 slots")
    counts_5, step_5 = serving_phase(torch, eng, read)
    phase("phase 4f: the same engine under the q4b flavours int8 and planes")
    counts_f, step_int8 = flavour_phase(torch, eng, read, prompt, long_prompt, n_new)
    del eng
    torch.cuda.empty_cache()

    phase("phase 4e: phase 4's weights with the int8 prefill (LLAMAFILE_TPU_I8P=1)")
    counts_e = i8p_phase(torch, dev, prompt, long_prompt, n_new)

    phase("phase 4c: main path, llama3-8b Q8_0, 32 layers, Engine.generate")
    eng, read = build_engine(torch, dev, "Q8_0")
    _, counts_c, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts_c, {"qmm_q8_m1": 1 + (4 * n_layers + 1) * steps,
                            "qmm_dequant": 4 * n_layers,
                            "flash_decode_write_stacked": n_layers * steps}, "phase 4c")
    step_q8 = decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")

    phase("phase 6: main path, llama3-8b Q4_K_M, 32 layers unrolled, Engine.generate "
        "and the HTTP server")
    counts_6 = q4km_phase(torch, dev, prompt, long_prompt, n_new)
    del eng
    torch.cuda.empty_cache()

    moe_engines, moe_steps, counts_7, moe_prompt = moe_phase(torch, dev, n_new)

    phase("phase 8: llama3.2-3b Q4_K (G = 3), 28 layers stacked, Engine.generate and the "
          "HTTP server")
    counts_8 = llama32_phase(torch, dev, prompt)

    phase("profiles of phase 7's Mixtral decodes, of phase 4c's Q8_0 decode on a rebuilt "
        "engine, then of phase 4, 4f's int8 decode and 4b on a rebuilt Q4_K engine")
    for what, eng7, step7 in zip(("7a Q4_K stacked", "7b Q4_K_M unrolled"), moe_engines,
                                 moe_steps):
        log(f"  phase {what}:")
        device_busy(torch, eng7, moe_prompt, sp, step7)
    del moe_engines, eng7
    torch.cuda.empty_cache()
    eng, _ = build_engine(torch, dev, "Q8_0")
    device_busy(torch, eng, prompt, sp, step_q8)
    del eng
    torch.cuda.empty_cache()
    eng, _ = build_engine(torch, dev, "Q4_K")
    device_busy(torch, eng, prompt, sp, step_q4)
    log("  phase 4f, LLAMAFILE_TPU_Q4B=int8:")
    with q4b_flavour("int8"):
        device_busy(torch, eng, prompt, sp, step_int8)
    prefill_profile(torch, eng, long_prompt)
    fused_profile(torch, eng, step_5)
    del eng
    torch.cuda.empty_cache()
    return ([counts, counts_b, counts_d, counts_c, counts_5] + counts_f + counts_e + counts_6
            + counts_7 + counts_8)


def llama32_phase(torch, dev, prompt, n_new=32):
    """Phase 8: Llama-3.2-3B's published widths (models.synthetic preset
    llama3.2-3b: 28 layers, 24 query heads over 8 KV heads, a head group of
    3), Q4_K, fused and stacked: Engine.generate of n_new greedy tokens from
    phase 4's 24-token prompt, launches exact as in phase 4 (the decode
    attention on flash_decode_write at G = 3), the decode rate against the
    weight-read bound; then the HTTP server at 4 slots (serve_four: 4 greedy
    requests, paged_attention at G = 3), those of the shortest and longest
    prompt against themselves served alone.
    No decode attention call takes the einsum or gather route. Returns the
    counted runs' launch counts."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3.2-3b", "Q4_K", seed=0, fuse=True, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    n = cfg.n_layers
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3.2-3b Q4_K ({n} layers, fused, stacked) in {time.time() - t0:.1f} s; "
        f"decode reads {read / 1e9:.3f} GB of weights a step")
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + (2 * n + 1) * steps, "qmm_txn": 4 * n,
                          "qmm_moe_m1": 2 * n * steps,
                          "flash_decode_write_stacked": n * steps}, "phase 8")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    routes = dict(A.ROUTE_COUNTS)
    expect = lambda d, small, big, fr: {
        "paged_attention": n * d,
        "qmm_txn": (4 * n + 1) * d + 4 * n * small, "qmm_dequant": 4 * n * big,
        "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
        "qmm_txn_m1": small + big}
    counts_s = serve_four(torch, eng, "synthetic-llama3.2-3b-q4k", "phase 8", expect)
    log(f"  phase 8 decode attention routes: generate {routes}, served {dict(A.ROUTE_COUNTS)}")
    if any(routes.values()) or any(A.ROUTE_COUNTS.values()):
        raise AssertionError("phase 8: a decode attention call left the kernel route")
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_s]


MOE_SERVED = (0, 1, 2, 3, 4, 5, 6, 7)      # two requests a prompt length
MOE_REQ = (0, 2, 3, 4, 5, 7, 8, 9)        # their _serve_request indices: greedy, half streamed


def moe_phase(torch, dev, n_new):
    """Phase 7: mixtral-8x7b-8l (Mixtral-8x7B's published widths, top-2 of 8
    experts, 8 layers sharing their weight buffers) at full width. 7a: Q4_K,
    stacked ([64, ...] expert stacks), Engine.generate of n_new greedy tokens
    from a 24-token prompt (the grouped qmm_txn_g at the bucket-32 prompt,
    the routed fused FFN at decode), then the 1000-token prompt's TTFT
    (qmm_planes_g). 7b: the same widths by the Q4_K_M recipe, unrolled
    (layers 0, 3, 6, 7 with Q6_K experts' down: the routed GEMVs at decode,
    the dense expert loop at prefill). 7c: the HTTP server at 8 slots over
    7a's engine, 8 greedy requests (prompts of 24, 128, 500 and 1000 tokens,
    two each), those of the shortest and longest prompt against themselves
    served alone. Launch counts exact.
    Returns ([7a's engine, 7b's engine], their decode step ms, the counted
    runs' counts, the 24-token prompt)."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import make_q4_k_m_llama, use_more_bits
    runs, engines, step_ms = [], [], []
    vocab = 32000                                   # Mixtral-8x7B's
    prompt = torch.randint(3, vocab, (24,), generator=torch.Generator().manual_seed(3)).tolist()
    long_prompt = torch.randint(3, vocab, (1000,),
                                generator=torch.Generator().manual_seed(4)).tolist()
    for tag, quant in (("7a", "Q4_K"), ("7b", "Q4_K_M")):
        phase(f"phase {tag}: mixtral-8x7b-8l {quant}, Engine.generate")
        t0 = time.time()
        if quant == "Q4_K_M":
            cfg, params = make_q4_k_m_llama("mixtral-8x7b-8l", seed=0, device=dev)
        else:
            cfg, params = make_synthetic_llama("mixtral-8x7b-8l", quant, seed=0, fuse=True,
                                               device=dev)
        eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
        del params
        n = cfg.n_layers
        six = [i for i in range(n) if use_more_bits(i, n)]
        stacked = not isinstance(eng.params.layers, list)
        if stacked != (quant == "Q4_K"):
            raise AssertionError(f"phase {tag}: the layers were {'' if stacked else 'not '}"
                                 "stacked")
        torch.cuda.synchronize()
        read = decode_read_bytes(eng.params, cfg)
        log(f"  built mixtral-8x7b-8l {quant} ({n} layers, "
            + ("stacked, expert stacks [64, ...]" if stacked else
               f"unrolled; Q6_K experts' down in layers {six}, attn_k/v Q8_0, attn_output "
               "Q5_K, output Q6_K") + f") in {time.time() - t0:.1f} s; a decode step "
            f"reads {read / 1e9:.3f} GB of weights (top-2 of 8 experts)")
        steps = n_new - 1
        _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
        if stacked:
            # a step: qkv and o GEMVs, the fused FFN (2 launches) and the
            # fused attention a layer, the head; the bucket-32 prompt: qkv
            # and o on qmm_txn, gate|up and down on qmm_txn_g (64 slots, tm 8)
            want = {"qmm_txn_m1": 1 + (2 * n + 1) * steps, "qmm_txn": 2 * n,
                    "qmm_txn_g": 2 * n, "qmm_moe_m1": 2 * n * steps,
                    "flash_decode_write_stacked": n * steps}
            long_want = {"qmm_dequant": 2 * n, "qmm_planes_g": 2 * n, "flash_prefill": n,
                         "qmm_txn_m1": 1}
        else:
            # a step: q on qmm_txn_m1, k, v (Q8_0) and o (Q5_K) on
            # qmm_q8_m1 a layer; the fused FFN in the Q4_K-down layers, the
            # routed GEMVs (gate|up q4b, down q8b) in the others; the Q6_K
            # head. The prompt: q on qmm_txn, k, v, o on the dequant GEMM;
            # qmm_txn_g in the Q4_K-down layers, the dense loop over 8
            # experts (gate|up on qmm_txn, down on the dequant GEMM) in the
            # others; a 1000-token prompt the same on qmm_planes and qmm_planes_g
            n4 = n - len(six)
            want = {"qmm_txn_m1": n * steps, "qmm_q8_m1": 1 + (3 * n + 1) * steps,
                    "qmm_moe_m1": 2 * n4 * steps, "qmm_txn_m1_r": len(six) * steps,
                    "qmm_q8_m1_r": len(six) * steps, "flash_decode_write_stacked": n * steps,
                    "qmm_txn": n + 8 * len(six), "qmm_dequant": 3 * n + 8 * len(six),
                    "qmm_txn_g": 2 * n4}
            long_want = {"qmm_planes": n + 8 * len(six), "qmm_dequant": 3 * n + 8 * len(six),
                         "qmm_planes_g": 2 * n4, "flash_prefill": n, "qmm_q8_m1": 1}
        check_counts(counts, want, f"phase {tag}")
        step_ms.append(decode_report(torch, read, steps, ttft, decode_s,
                                     "24-token prompt, bucket 32"))
        ttfts = []
        for _ in range(3):
            _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
            check_counts(counts_b, long_want, f"phase {tag}, 1000 tokens")
            ttfts.append(ttft_b * 1e3)
        log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
            f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
        runs += [counts, counts_b]
        engines.append(eng)
        del eng
    phase("phase 7c: the HTTP server over 7a's engine, 8 slots, 8 greedy requests")
    runs.append(moe_serving(torch, engines[0]))
    return engines, step_ms, runs, prompt


def moe_serving(torch, eng):
    """Phase 7c: 8 greedy requests through the port's Server at 8 slots over
    the stacked Mixtral engine, launches exact from the batcher's tallies;
    each request of the shortest and longest prompt served again alone by a
    fresh batcher gives the same ids."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.models.llama import grouped_tm
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    cfg = eng.cfg
    n, k = cfg.n_layers, cfg.n_experts_used
    srv = Server(Flags(model="synthetic-mixtral-8x7b-q4k", slots=8, temp=0.0), eng)
    gen = torch.Generator().manual_seed(9)
    prompts = {i: torch.randint(3, cfg.n_vocab, (SERVE_LENGTHS[i % 4],), generator=gen).tolist()
               for i in MOE_SERVED}
    with running_server(srv) as base:
        _serve_request(base, 3, torch.randint(3, cfg.n_vocab, (40,), generator=gen).tolist(),
                       False)                                # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            results = dict(zip(MOE_SERVED, ex.map(
                lambda i: _serve_request(base, MOE_REQ[i], prompts[i], False), MOE_SERVED)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, r[3]) for i, r in results.items() if r[3]]
        if errors:
            raise AssertionError(f"phase 7c requests failed: {errors}")
        n_out = sum(r[1]["completion_tokens"] for r in results.values())
        log(f"  8 requests (prompts {SERVE_LENGTHS} x 2, 64 new tokens), {n_out} tokens out "
            f"in {wall:.3f} s: {n_out / wall:.2f} output tok/s")
        for L in SERVE_LENGTHS:
            t = sorted((r[2] * 1e3 if r[2] is not None else r[1]["ttft_ms"]) for i, r in
                       results.items() if SERVE_LENGTHS[i % 4] == L)
            log(f"  prompt {L}: TTFT {', '.join(f'{v:.2f}' for v in t)} ms (streamed: client "
                "first token event; plain: the server's ttft_ms)")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        delta = lambda key: {b: c - st0[key].get(b, 0) for b, c in st1[key].items()}
        dsteps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(c for b, c in allb.items() if b <= 32)
        big = sum(c for b, c in allb.items() if b >= 64)
        txn_g = sum(c for b, c in allb.items() if grouped_tm(k * b) <= 32)
        planes_g = sum(c for b, c in allb.items() if grouped_tm(k * b) > 32)
        log(f"  batcher tallies: {dsteps} fused decode steps at 8 rows (16 slots: qmm_txn_g), "
            f"admission slices by bucket {allb} (fresh {fr})")
        # a step: qkv, o and the head on qmm_txn (8 rows), the grouped FFN
        # (2 qmm_txn_g), paged attention; a slice: qkv and o on qmm_txn
        # (bucket <= 32) or the dequant GEMM, the grouped FFN by its tile
        # size, the head at M = 1
        check_counts(counts, {
            "paged_attention": n * dsteps, "qmm_txn": (2 * n + 1) * dsteps + 2 * n * small,
            "qmm_txn_g": 2 * n * (dsteps + txn_g), "qmm_planes_g": 2 * n * planes_g,
            "qmm_dequant": 2 * n * big,
            "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
            "qmm_txn_m1": small + big}, "phase 7c")
    alone = Batcher(eng, rows=8)
    try:
        for i in (i for i in MOE_SERVED if len(prompts[i]) in ALONE_LENGTHS):
            toks = _alone_tokens(alone, prompts[i], srv._sp({"temperature": 0.0}))
            same = toks == results[i][0]
            log(f"  request {i} (prompt {len(prompts[i])}): alone {len(toks)} tokens, "
                f"{'the same ids' if same else 'DIFFERENT ids'} as served beside the others")
            if not same:
                raise AssertionError(f"phase 7c request {i}: {toks} alone, "
                                     f"{results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return counts


SERVE_SAMPLED = (1, 6, 11, 12)        # request indices sampled at temperature 0.8
SERVE_CHAT = (14, 15)                 # request indices sent as chat messages


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_request(base, i, ids, chat):
    """Request i of phase 5 over HTTP; returns (token ids, usage, client TTFT
    s or None, error or None). Streamed requests take their TTFT at the
    first token event."""
    import urllib.request
    body = {"max_tokens": 64, "stream": i % 2 == 0}
    if i in SERVE_SAMPLED:
        body.update(temperature=0.8, top_k=40, seed=i)
    else:
        body.update(temperature=0.0)
    if chat:
        # Tokenizer({}) maps each byte to one token: a message of about the
        # prompt length (the chat template adds its own tokens)
        body["messages"] = [{"role": "user", "content": "x" * (len(ids) - 40)}]
        path = "/v1/chat/completions"
    else:
        body["prompt"] = ids
        path = "/v1/completions"
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, text, usage = None, "", None
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            if not body["stream"]:
                out = json.loads(r.read())
                ch = out["choices"][0]
                text = ch["message"]["content"] if chat else ch["text"]
                usage = out["usage"]
            else:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    evt = json.loads(line[6:])
                    if "error" in evt:
                        return [], None, None, evt["error"]
                    ch = evt["choices"][0]
                    piece = (ch.get("delta") or {}).get("content", "") if chat \
                        else ch.get("text", "")
                    if piece and ttft is None:
                        ttft = time.perf_counter() - t0
                    text += piece
                    usage = evt.get("usage", usage)
    except Exception as e:                     # noqa: BLE001 — reported, then raised
        return [], None, None, repr(e)
    # Tokenizer({}) decodes token t as "<t>": the text carries the ids
    return [int(t) for t in re.findall(r"<(\d+)>", text)], usage, ttft, None


def _alone_tokens(batcher, ids, sp):
    toks = []
    req = batcher.submit(ids, sp, 64)
    while True:
        kind, val = req.out.get(timeout=900)
        if kind == "token":
            toks.append(val)
        elif kind == "done":
            return toks
        elif kind == "error":
            raise AssertionError(f"alone run: {val}")


@contextlib.contextmanager
def running_server(srv):
    """The port's HTTP server srv on a free 127.0.0.1 port, in a thread of
    this process, until the block ends; yields its base URL."""
    import asyncio
    import urllib.request
    from llamafile_tpu_torch.server.http import _amain
    port = _free_port()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(_amain(srv, "127.0.0.1", port))
        except RuntimeError:
            pass                               # loop.stop() at the end
    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                urllib.request.urlopen(base + "/health", timeout=5)
                break
            except Exception:
                time.sleep(0.1)
        yield base
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        srv.batcher.shutdown()
        srv.pool.shutdown(wait=False)


def serving_phase(torch, eng, read):
    """Phase 5: the port's Server at full width, 8 slots, 16 requests from 8
    client threads. Returns (the launch counts of the counted run, the fused
    8-row step's time in ms)."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    srv = Server(Flags(model="synthetic-llama3-8b-q4k", slots=8, temp=0.0), eng)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, eng.cfg.n_vocab, (SERVE_LENGTHS[i % 4],),
                             generator=gen).tolist() for i in range(16)]
    with running_server(srv) as base:
        # warm-up (first launches at these shapes, allocator): not counted
        warm = torch.randint(3, eng.cfg.n_vocab, (40,), generator=gen).tolist()
        _serve_request(base, 0, warm, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(lambda i: _serve_request(base, i, prompts[i],
                                                           i in SERVE_CHAT), range(16)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, e) for i, (_, _, _, e) in enumerate(results) if e]
        if errors:
            raise AssertionError(f"phase 5 requests failed: {errors}")
        n_out = sum(u["completion_tokens"] for _, u, _, _ in results)
        log(f"  16 requests, {n_out} tokens out in {wall:.3f} s: {n_out / wall:.2f} "
            f"output tok/s (8 slots, prompts {SERVE_LENGTHS} x 4, 64 new tokens)")
        for n in SERVE_LENGTHS:
            sel = [(i, results[i]) for i in range(16) if SERVE_LENGTHS[i % 4] == n]
            ttfts = sorted((res[2] if res[2] is not None else res[1]["ttft_ms"] / 1e3)
                           for _, res in sel)
            log(f"  prompt {n}: TTFT p50 {statistics.median(ttfts) * 1e3:.2f} ms, max "
                f"{max(ttfts) * 1e3:.2f} ms (streamed: client first token event; plain: "
                f"the server's ttft_ms); prompt tokens "
                f"{[res[1]['prompt_tokens'] for _, res in sel]}")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        delta = lambda k: {b: n - st0[k].get(b, 0) for b, n in st1[k].items()}
        steps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(n for b, n in allb.items() if b <= 32)
        big = sum(n for b, n in allb.items() if b >= 64)
        n_layers = eng.cfg.n_layers
        expect = {"paged_attention": n_layers * steps,
                  "qmm_txn": (4 * n_layers + 1) * steps + 4 * n_layers * small,
                  "qmm_dequant": 4 * n_layers * big,
                  "flash_prefill": n_layers * sum(n for b, n in fr.items() if b >= 128),
                  "qmm_txn_m1": small + big}
        log(f"  batcher tallies: {steps} fused decode steps, admission slices by bucket "
            f"{allb} (fresh {fr})")
        check_counts(counts, expect, "phase 5")
        if not srv.batcher.alive():
            raise AssertionError("phase 5: the batcher's device thread died")
    # the same requests alone, one after another, on a fresh 8-slot batcher
    greedy = [next(i for i in range(16) if SERVE_LENGTHS[i % 4] == n and i not in
                   SERVE_SAMPLED and i not in SERVE_CHAT) for n in SERVE_LENGTHS]
    check_ids = [i for i in greedy if SERVE_LENGTHS[i % 4] in ALONE_LENGTHS] + [SERVE_SAMPLED[0]]
    alone = Batcher(eng, rows=8)
    try:
        for i in check_ids:
            sp = srv._sp({"temperature": 0.8, "top_k": 40, "seed": i}
                         if i in SERVE_SAMPLED else {"temperature": 0.0})
            toks = _alone_tokens(alone, prompts[i], sp)
            same = toks == results[i][0]
            log(f"  request {i} (prompt {SERVE_LENGTHS[i % 4]}, "
                f"{'sampled' if i in SERVE_SAMPLED else 'greedy'}): alone "
                f"{len(toks)} tokens, {'the same ids' if same else 'DIFFERENT ids'} "
                "as served beside the others")
            if not same:
                raise AssertionError(f"request {i}: {toks} alone, {results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return counts, fused_step(torch, eng, read)


Q4KM_SERVED = (0, 2, 3, 5)          # phase 5's greedy request indices: 2 streamed


def q4km_phase(torch, dev, prompt, long_prompt, n_new):
    """Phase 6: llama3-8b by the Q4_K_M recipe, 32 layers, unrolled, through
    Engine.generate (24-token prompt, n_new greedy tokens; then the
    1000-token prompt's TTFT) and the HTTP server at 4 slots (4 greedy
    requests, those of the shortest and longest prompt against themselves
    served alone). Launch counts
    exact, from the recipe's layer list. Returns the counted runs' counts."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import make_q4_k_m_llama, use_more_bits
    t0 = time.time()
    cfg, params = make_q4_k_m_llama("llama3-8b", seed=0, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    n = cfg.n_layers
    six = [i for i in range(n) if use_more_bits(i, n)]
    n6 = len(six)
    if not isinstance(eng.params.layers, list):
        raise AssertionError("phase 6: the Q4_K_M layers were stacked")
    torch.cuda.synchronize()
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b Q4_K_M ({n} layers, unrolled; attn_v and ffn_down Q6_K "
        f"in layers {six}, output Q6_K) in {time.time() - t0:.1f} s; decode reads "
        f"{read / 1e9:.3f} GB of weights a step")
    steps = n_new - 1
    # a step: four q4b GEMVs a layer (qkv or q and k, o, gate|up, down of the
    # Q4_K layers), the Q6_K V and down and the head on the q8b GEMV; a
    # bucket-32 prompt: the same products on qmm_txn and the dequant GEMM
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 4 * n * steps, "qmm_q8_m1": 1 + (2 * n6 + 1) * steps,
                          "flash_decode_write_stacked": n * steps, "qmm_txn": 4 * n,
                          "qmm_dequant": 2 * n6}, "phase 6")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_planes": 4 * n, "qmm_dequant": 2 * n6,
                                "flash_prefill": n, "qmm_q8_m1": 1}, "phase 6, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")

    log("  the HTTP server on this engine, 4 slots, 4 greedy requests")
    # a 4-row step: q4b products on qmm_txn, Q6_K ones and the head on
    # the dequant GEMM; a slice: qmm_txn (bucket <= 32) or qmm_planes
    # (>= 64) and the dequant GEMM, the head at M = 1 on the q8b GEMV
    counts_s = serve_four(torch, eng, "synthetic-llama3-8b-q4_k_m", "phase 6",
                          lambda d, small, big, fr: {
        "paged_attention": n * d,
        "qmm_txn": 4 * n * (d + small),
        "qmm_dequant": (2 * n6 + 1) * d + 2 * n6 * (small + big),
        "qmm_planes": 4 * n * big,
        "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
        "qmm_q8_m1": small + big})
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_b, counts_s]


def serve_four(torch, eng, model, what, expect):
    """The port's HTTP server over eng at 4 slots: 4 greedy requests (the
    prompts of SERVE_LENGTHS, as phase 5's requests Q4KM_SERVED: 2 streamed)
    from 4 client threads, launch counts exact (expect(decode steps, small
    slices, big slices, fresh slices by bucket) from the batcher's tallies),
    then each request alone on a fresh 4-row batcher, which must give the
    same ids. Returns the counted run's launch counts."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    n_vocab = eng.cfg.n_vocab
    srv = Server(Flags(model=model, slots=4, temp=0.0), eng)
    gen = torch.Generator().manual_seed(8)
    prompts = {i: torch.randint(3, n_vocab, (SERVE_LENGTHS[k],), generator=gen).tolist()
               for k, i in enumerate(Q4KM_SERVED)}
    with running_server(srv) as base:
        # warm-up (not counted), a prompt that shares no prefix with the
        # requests: a reused prefix would admit request 0 by another path
        _serve_request(base, 0, torch.randint(3, n_vocab, (40,), generator=gen).tolist(), False)
        torch.cuda.synchronize()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            results = dict(zip(Q4KM_SERVED, ex.map(
                lambda i: _serve_request(base, i, prompts[i], False), Q4KM_SERVED)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, r[3]) for i, r in results.items() if r[3]]
        if errors:
            raise AssertionError(f"{what} requests failed: {errors}")
        n_out = sum(r[1]["completion_tokens"] for r in results.values())
        log(f"  4 requests (prompts {SERVE_LENGTHS}), {n_out} tokens out in {wall:.3f} s: "
            f"{n_out / wall:.2f} output tok/s")
        delta = lambda k: {b: c - st0[k].get(b, 0) for b, c in st1[k].items()}
        dsteps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(c for b, c in allb.items() if b <= 32)
        big = sum(c for b, c in allb.items() if b >= 64)
        log(f"  batcher tallies: {dsteps} fused decode steps at 4 rows, admission slices "
            f"by bucket {allb} (fresh {fr})")
        check_counts(counts, expect(dsteps, small, big, fr), f"{what} serving")
    alone = Batcher(eng, rows=4)
    try:
        for i in (i for i in Q4KM_SERVED if len(prompts[i]) in ALONE_LENGTHS):
            toks = _alone_tokens(alone, prompts[i], srv._sp({"temperature": 0.0}))
            same = toks == results[i][0]
            log(f"  request {i} (prompt {len(prompts[i])}): alone {len(toks)} tokens, "
                f"{'the same ids' if same else 'DIFFERENT ids'} as served beside the others")
            if not same:
                raise AssertionError(f"{what} request {i}: {toks} alone, "
                                     f"{results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return counts


def flavour_phase(torch, eng, read, prompt, long_prompt, n_new):
    """Phase 4f: phase 4's llama3-8b Q4_K engine (stacked; its weights do not
    depend on the flavour) under LLAMAFILE_TPU_Q4B=int8, then =planes
    (qmatmul.Q4B_KERNEL set, txn restored after). Each: Engine.generate of
    n_new greedy tokens from the 24-token prompt (int8: every q4b product
    on qmm_int8, 4 a layer and the head, at the bucket-32 prefill and each
    decode step padded to M = 8, the FFN unfused; planes: the same products
    on qmm_planes), then the 1000-token prompt's TTFT, median of 3 (the
    stacked planes kernel, row 12, for the four products of each layer; the
    head at M = 1 on the flavour's decode kernel). Under int8 also the HTTP
    server at 4 slots (serve_four: a 4-row step padded to 8 on qmm_int8).
    Launch counts exact. Returns (the counted runs' counts, the int8 decode
    step in ms)."""
    n = eng.cfg.n_layers
    steps = n_new - 1
    runs, step_ms = [], {}
    for fl, kern in (("int8", "qmm_int8"), ("planes", "qmm_planes")):
        with q4b_flavour(fl):
            _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
            want = {kern: (4 * n + 1) * (1 + steps), "flash_decode_write_stacked": n * steps}
            if fl == "planes":
                # all but the unstacked head on a stacked layer's view
                want["qmm_planes_stacked"] = 4 * n * (1 + steps)
            check_counts(counts, want, f"phase 4f {fl}")
            step_ms[fl] = decode_report(torch, read, steps, ttft, decode_s,
                                        f"24-token prompt, bucket 32, LLAMAFILE_TPU_Q4B={fl}")
            ttfts = []
            for _ in range(3):
                _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
                want = {"qmm_planes": 4 * n, "qmm_planes_stacked": 4 * n, "flash_prefill": n}
                want[kern] = want.get(kern, 0) + 1
                check_counts(counts_b, want, f"phase 4f {fl}, 1000 tokens")
                ttfts.append(ttft_b * 1e3)
            log(f"  time to first token, 1000-token prompt, LLAMAFILE_TPU_Q4B={fl}: "
                f"{statistics.median(ttfts):.2f} ms (median of "
                f"{', '.join(f'{t:.2f}' for t in ttfts)} ms)")
            runs += [counts, counts_b]
            if fl == "int8":
                log("  the HTTP server on this engine under int8, 4 slots, 4 greedy requests")
                # a 4-row step padded to 8 and a slice's head at M = 1 on
                # qmm_int8; a slice's products on qmm_int8 (bucket <= 32) or
                # the stacked planes kernel (>= 64)
                expect = lambda d, small, big, fr: {
                    "paged_attention": n * d,
                    "qmm_int8": (4 * n + 1) * d + 4 * n * small + small + big,
                    "qmm_planes": 4 * n * big, "qmm_planes_stacked": 4 * n * big,
                    "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128)}
                runs.append(serve_four(torch, eng, "synthetic-llama3-8b-q4k", "phase 4f int8",
                                       expect))
    return runs, step_ms["int8"]


FUSED_LENGTHS = (88, 192, 564, 1064) * 2      # the phase's prompts + 64 tokens


def _fused_setup(torch, eng):
    """A pool, tables and row state for one fused decode chunk at 8 rows."""
    from llamafile_tpu_torch.runtime.paged import PageAllocator, init_paged
    from llamafile_tpu_torch.runtime.sampling import (PenaltyWindow, SamplingParams,
                                                      row_params_from_sp)
    dev, cfg, r, ps = eng.device, eng.cfg, len(FUSED_LENGTHS), 64
    maxp = eng.max_seq_len // ps
    pool = init_paged(cfg.n_layers, cfg.n_kv_heads, 1 + r * maxp, ps, cfg.head_dim,
                      device=dev)
    alloc = PageAllocator(1 + r * maxp, ps, r, eng.max_seq_len)
    for i, n in enumerate(FUSED_LENGTHS):
        alloc.ensure(i, n + 16)
    z = lambda shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    pw = PenaltyWindow(torch.zeros((r, cfg.n_vocab), device=dev), z((r, 256)), z((r,)),
                       z((r,)))
    rp = row_params_from_sp([SamplingParams(temperature=0.0)] * r, cfg.n_vocab, device=dev)
    tok = torch.full((r,), 5, dtype=torch.int32, device=dev)
    pos = torch.tensor(FUSED_LENGTHS, dtype=torch.int32, device=dev)
    return pool, alloc.device_tables(r, device=dev), pw, rp, tok, pos


def fused_step(torch, eng, read):
    """The batcher's fused decode at 8 rows (rows at the phase's lengths),
    timed by the host clock around synchronized 8-step chunks, against its
    bound: the weights plus every row's K/V read once a step."""
    from llamafile_tpu_torch.server.batcher import _fused_decode_paged
    pool, tables, pw, rp, tok, pos = _fused_setup(torch, eng)
    run = lambda: _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 8 * 1e3)
    step_ms = statistics.median(times)
    kv = sum(FUSED_LENGTHS) * KV_BYTES_PER_TOKEN
    bound = (read + kv) / HBM_BYTES_PER_S * 1e3
    log(f"  fused decode step at 8 rows (lengths {FUSED_LENGTHS}): {step_ms:.3f} ms "
        f"(median of {', '.join(f'{t:.3f}' for t in times)}) against a "
        f"{bound:.3f} ms bound ({read / 1e9:.3f} GB weights + {kv / 1e9:.3f} GB KV): "
        f"{bound / step_ms:.1%}; {8 / step_ms * 1e3:.1f} tokens/s over 8 rows")
    return step_ms


def fused_profile(torch, eng, step_ms):
    """Device busy share of one fused 8-row decode chunk under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from llamafile_tpu_torch.server.batcher import _fused_decode_paged
    pool, tables, pw, rp, tok, pos = _fused_setup(torch, eng)
    _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / 8
    if busy_ms == 0:
        log("  fused step busy share: not measured (the profiler recorded no kernels)")
        return
    log(f"  fused 8-row step: device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms step "
        f"({busy_ms / step_ms:.1%}); {n_act / 8:.1f} device activities a step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 8 / 1e3:8.4f} ms/step  {name[:90]}")


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


PROFILE_STEPS = 2                 # decode steps a profiled chunk (device_busy)


def device_busy(torch, eng, prompt, sp, step_ms):
    """Kernel time of one PROFILE_STEPS-step decode chunk from a profiler
    trace, against the unprofiled step time: the device's busy share of a
    decode step; then the host's time by function over as many steps."""
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_STEPS
    cache = eng.new_cache()
    last, cache = eng.prefill(cache, prompt)
    tok = last.argmax()[None].to(torch.int32)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=tok.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.decode(tok, pos, cache, None, sp, n, attn_len=256)
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / n
    if busy_ms == 0:
        log("  device busy share: not measured (the profiler recorded no kernels)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms decode step "
        f"({busy_ms / step_ms:.1%}); idle {1 - busy_ms / step_ms:.1%}")
    fdw = sum(us for name, us in by_name.items() if "fdw_kernel" in name)
    if fdw:
        log(f"  flash_decode_write: {fdw / n / 1e3:.4f} ms/step of device time")
    log(f"  {n_act / n:.1f} device activities (kernels, copies, fills) a step: "
        f"{step_ms * 1e3 / (n_act / n):.1f} us of step time each")
    for name, us in top:
        log(f"    {us / n / 1e3:8.4f} ms/step  {name[:90]}")
    # the host side: the next n steps under cProfile, by function's own time
    prof_py = cProfile.Profile()
    t0 = time.perf_counter()
    prof_py.enable()
    eng.decode(tok, pos, cache, None, sp, n, attn_len=256)
    torch.cuda.synchronize()
    prof_py.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    stats = pstats.Stats(prof_py).stats
    log(f"  host time by function, cProfile on ({wall_ms:.3f} ms a step with it):")
    for (path, line, fn), (_, calls, own, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"    {own / n * 1e3:8.4f} ms/step {calls / n:7.1f} calls  "
            f"{fn[:60]} ({os.path.basename(path)}:{line})")


def phase3_checks():
    """Phase 3's checks: (what, check, args, kwargs, q4b flavour)."""
    # each check runs its CPU side through the plain versions at two layers
    # of full width: its depth (decode steps, prompts) is cut to what drives
    # and holds each route once; the bucket-512 grouped MoE prefill
    # (qmm_planes_g) is held on the Q4_K_M Mixtral, the planes flavour's
    # bucket-512 prefill (qmm_planes, stacked) under int8, which runs the
    # same kernel there
    mix = dict(preset="mixtral-8x7b-2l", n_decode=1)
    return (
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "txn"),
        ("Q4_K, 300-token prompt", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1), "txn"),
        ("Q4_K, 300-token prompt, int8 prefill", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1, i8p=True), "txn"),
        ("head_dim 64 (TinyLlama widths)", head_dim_64_check, (), dict(n_decode=2), "txn"),
        ("Llama-3.2-3B widths (G = 3)", decode_model_check, (), dict(n_decode=1), "txn"),
        # head_dim 256: flash_decode_write, flash_decode and
        # paged_attention at D = 256 on a model's path
        ("head_dim 256 (Gemma-2B widths, G = 8)", decode_model_check, (),
         dict(preset="gemma-2b-widths-2l", n_decode=1, paged_prompts=(24, 200)), "txn"),
        ("Q8_0", whole_path_check, ("Q8_0",), dict(n_prompt=24, n_decode=1), "txn"),
        ("paged decode, 4 rows", paged_path_check, (), dict(n_decode=1), "txn"),
        ("Q4_K_M", whole_path_check, ("Q4_K_M",), dict(n_prompt=300, n_decode=1), "txn"),
        ("int8 KV", whole_path_check, ("Q4_K",),
         dict(n_prompt=32, n_decode=1, kv_dtype="int8"), "txn"),
        ("Mixtral Q4_K stacked", moe_path_check, ("Q4_K",),
         dict(runs=((24, 1),)), "txn"),
        ("Mixtral Q4_K_M unrolled", moe_path_check, ("Q4_K_M",),
         dict(runs=((300, 1),)), "txn"),
        ("Mixtral paged decode, 4 rows", paged_path_check, (),
         dict(prompts=(24, 64, 200, 300), **mix), "txn"),
        ("Mixtral paged decode, 8 rows", paged_path_check, (),
         dict(prompts=(24, 64, 200, 300) * 2, **mix), "txn"),
        # the q4b flavours (LLAMAFILE_TPU_Q4B): int8 runs qmm_int8 at
        # padded M <= 32 and the stacked planes kernel above (bf16 out
        # at bucket 512), planes the planes kernel for every q4b
        # product; Q8_0 decode leaves qmm_q8_m1 for the dequant GEMM;
        # the paged decode's 4 rows pad to 8 on qmm_int8; Mixtral's
        # decode takes _routed_fallback
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "int8"),
        ("Q4_K, 300-token prompt", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1), "int8"),
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "planes"),
        ("Q8_0", whole_path_check, ("Q8_0",), dict(n_prompt=24, n_decode=1), "int8"),
        ("paged decode, 4 rows", paged_path_check, (), dict(n_decode=1), "int8"),
        ("Mixtral Q4_K stacked", moe_path_check, ("Q4_K",),
         dict(runs=((24, 1),)), "int8"))


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
    phase("phase 2: kernels against their plain versions at the main path's shapes")
    rows = kernel_phases(torch, dev, gen)
    phase("phase 3: whole paths, llama3-8b width, 2 layers: card vs CPU plain")
    for what, check, args, kw, fl in phase3_checks():
        phase(f"  phase 3 {what}{'' if fl == 'txn' else ', LLAMAFILE_TPU_Q4B=' + fl}")
        with q4b_flavour(fl):
            check(torch, dev, *args, **kw)
    phase("phase 4: main path, llama3-8b Q4_K, 32 layers, Engine.generate")
    runs = main_path(torch, dev)
    launched = {name: sum(c[name] for c in runs) for name in runs[0]}
    for r in rows:
        key = "flash_decode_write_stacked" if r["name"] == "flash_decode_write" else r["name"]
        r["launches"] = launched[key]
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was launched by no main-path run")
        if r["name"] == "qmm_planes":
            # row 12's share: the launches on a stacked layer's view
            r["stacked_launches"] = launched["qmm_planes_stacked"]
            if r["stacked_launches"] == 0:
                raise AssertionError("qmm_planes ran on no stacked layer in the main paths")
    from llamafile_tpu_torch.ops import kernel_wrappers
    if len(rows) != len(kernel_wrappers()):
        raise AssertionError(f"{len(rows)} kernels measured, {len(kernel_wrappers())} wrapped")
    phase("done")
    print(json.dumps({"phase_seconds": {m: round(t1 - t0, 1) for (m, t0), (_, t1)
                                        in zip(PHASE_TIMES, PHASE_TIMES[1:])}}))
    print(json.dumps({"launches": launched}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
