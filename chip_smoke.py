#!/usr/bin/env python3
"""Drive llamafile_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

1. Set-up: the card's name and power limit, torch/CUDA/nvcc versions, and a
   parallel build of every CUDA kernel from llamafile_tpu_torch/csrc/.
2. Each kernel at the shapes of the llama3-8b Q4_K main path, held against
   its plain PyTorch version on the same inputs (the tolerances of the CPU
   tests) and timed on the device: a run of launches cycling over enough
   layers of weights to spill the 50 MB L2 (as decode does) is captured in a
   CUDA graph and replayed between CUDA events, median of 25 replays, so the
   host's dispatch cost is left out. Timed: the kernel, its plain version,
   one PyTorch library call computing the same function where there is one,
   and the bound (bytes over the card's memory rate, or operations over its
   peak rate, whichever is larger).
3. Whole path at two layers of llama3-8b width: prefill of 32 tokens and 8
   decode steps on the card, against the same model on the CPU through the
   plain versions.
4. The main path at full width: make_synthetic_llama("llama3-8b", Q4_K,
   fused, 32 layers) -> Engine -> greedy generate of 64 tokens from a
   24-token prompt, with every launch count set to 0 just before and read
   just after; decode rate, time to first token and the weight-read bound,
   then one 8-step decode chunk under torch.profiler for the device's busy
   share of a step.

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the lines before it hold the kernel table
(one JSON object with an entry a kernel: the numbers of its first shape, the
main path's heaviest, and every measured shape under "shapes") and the
card's name and power limit.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
SAMPLES = 25


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


def rand_q4b(torch, gen, layers, n, k, dev):
    """Stacked random Q4_K weights in the production layout."""
    qs = torch.randint(0, 256, (layers, k // 2, n), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = torch.empty((layers, k // 32, n), device=dev).uniform_(1e-3, 2e-2, generator=gen)
    b = torch.empty((layers, k // 32, n), device=dev).uniform_(-0.1, 0.0, generator=gen)
    return qs, sc.to(torch.bfloat16), b.to(torch.bfloat16)


def q4b_bytes(qs, sc, b):
    return sum(t[0].numel() * t.element_size() for t in (qs, sc, b))


def check_close(name, got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    log(f"  {name}: max_abs_err {err:.6g} (max |ref| {scale:.6g}, tol {rel} x max)")
    if not err <= rel * max(scale, 1e-30):
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{err} > {rel} x {scale}")
    return err


def kernel_phases(torch, dev, gen):
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops.repack import q4b_codes
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
        qs, sc, b = rand_q4b(torch, gen, layers, n, k, dev)
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
        qs, sc, b = rand_q4b(torch, gen, layers, n, k, dev)
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

    # --- qmm_moe_m1: the fused decode FFN, layer as expert ---------------
    d, dff, layers = 4096, 14336, 2
    gq, gs, gb = rand_q4b(torch, gen, layers, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(torch, gen, layers, d, dff, dev)
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


def whole_path_check(torch, dev):
    """Two layers at llama3-8b width: card (kernels) vs CPU (plain versions)."""
    from llamafile_tpu_torch.models.llama import forward, init_cache, stack_layers
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    cfg, params = make_synthetic_llama("llama3-8b-2l", "Q4_K", seed=1, fuse=True,
                                       device=dev)
    gpu = stack_layers(params)
    cpu = _to(gpu, "cpu")
    toks = torch.randint(3, cfg.n_vocab, (1, 32), generator=torch.Generator().manual_seed(2))
    caches = {d: init_cache(cfg, 1, 256, device=d) for d in ("cuda", "cpu")}
    logits = {}
    for d, p in (("cuda", gpu), ("cpu", cpu)):
        lg, _ = forward(p, cfg, toks.to(d), torch.zeros(1, dtype=torch.int32, device=d),
                        caches[d], fresh_prefill=True,
                        last_idx=torch.tensor([31], device=d))
        logits[d] = [lg[0, -1].float().cpu()]
    nxt = int(logits["cuda"][0].argmax())
    for step in range(8):
        for d, p in (("cuda", gpu), ("cpu", cpu)):
            lg, _ = forward(p, cfg, torch.tensor([[nxt]], device=d),
                            torch.tensor([32 + step], dtype=torch.int32, device=d),
                            caches[d], attn_len=256)
            logits[d].append(lg[0, -1].float().cpu())
        nxt = int(logits["cuda"][-1].argmax())
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  step {i}: top-1 card {int(a.argmax())} cpu {int(b.argmax())}, "
            f"max |diff| / max |logit| = {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"whole path step {i}: card and CPU disagree")
    del gpu, cpu, params
    torch.cuda.empty_cache()


def main_path(torch, dev):
    """The port's main path at full width through its user entry points."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.ops import kernel_wrappers, reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3-8b", "Q4_K", seed=0, fuse=True, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.time() - t0
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b Q4_K (32 layers, fused, stacked) in {build_s:.1f} s; "
        f"decode reads {read / 1e9:.3f} GB of weights a step")
    prompt = [int(t) for t in torch.randint(3, cfg.n_vocab, (24,),
                                            generator=torch.Generator().manual_seed(3))]
    sp = SamplingParams(temperature=0.0)
    n_new = 64
    # warm-up (first launches of each kernel, allocator); not counted
    list(eng.generate("", max_tokens=9, sampling=sp, stop_on_eog=False, prompt_ids=prompt))
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
    steps = n_new - 1
    expect = {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * cfg.n_layers,
              "qmm_moe_m1": 64 * steps, "flash_decode_write_stacked": 32 * steps}
    log(f"  launches in the main path: {counts} (expected {expect})")
    if len(toks) != n_new or any(t < 0 or t >= cfg.n_vocab for t in toks):
        raise AssertionError(f"main path produced {toks}")
    if counts != expect:
        raise AssertionError("the main path did not run through the kernels as expected")
    decode_s = t_end - t_first
    step_ms = decode_s / steps * 1e3
    bound = read / HBM_BYTES_PER_S * 1e3
    log(f"  time to first token {(t_first - t0) * 1e3:.2f} ms (24-token prompt, bucket 32)")
    log(f"  decode {steps / decode_s:.2f} tok/s = {step_ms:.3f} ms a step; "
        f"weight-read bound {bound:.3f} ms a step ({bound / step_ms:.1%})")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    device_busy(torch, eng, prompt, sp, step_ms)
    return counts


def device_busy(torch, eng, prompt, sp, step_ms):
    """Kernel time of one 8-step decode chunk from a profiler trace, against
    the unprofiled step time: the device's busy share of a decode step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = eng.new_cache()
    last, cache = eng.prefill(cache, prompt)
    tok = last.argmax()[None].to(torch.int32)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=tok.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.decode(tok, pos, cache, None, sp, 8, attn_len=256)
        torch.cuda.synchronize()
    by_name, n_act = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            n_act += 1
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
    log("phase 3: whole path, llama3-8b width, 2 layers: card vs CPU plain")
    whole_path_check(torch, dev)
    log("phase 4: main path, llama3-8b Q4_K, 32 layers, Engine.generate")
    counts = main_path(torch, dev)
    for r in rows:
        key = "flash_decode_write_stacked" if r["name"] == "flash_decode_write" else r["name"]
        r["launches"] = counts[key]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
