"""Random kernel inputs and error measures shared by the card tests
(tests/test_torch_cuda.py), the CPU parity tests and chip_smoke.py.

Nothing of the model path imports this module.
"""
from __future__ import annotations

import torch

from .ops.attention import NEG_INF


def rand_q4b(gen: torch.Generator, layers: int, n: int, k: int, device):
    """Stacked random Q4_K weights in the production layout: (qs uint8
    [L, K/2, N], scales bf16 [L, K/32, N], bias bf16 [L, K/32, N])."""
    qs = torch.randint(0, 256, (layers, k // 2, n), generator=gen, device=device,
                       dtype=torch.uint8)
    sc = torch.empty((layers, k // 32, n), device=device).uniform_(1e-3, 2e-2, generator=gen)
    b = torch.empty((layers, k // 32, n), device=device).uniform_(-0.1, 0.0, generator=gen)
    return qs, sc.to(torch.bfloat16), b.to(torch.bfloat16)


def rand_q8b(gen: torch.Generator, layers: int, n: int, k: int, g: int, device):
    """Stacked random int8-stored weights (Q8_0: g 32, Q6_K: g 16): (qs int8
    [L, K, N], scales bf16 [L, K/g, N], bias bf16 [L, K/g, N]); the bias
    feeds the fused bias term of qmm_q8_m1, the model's q8b leaves have none."""
    qs = torch.randint(-127, 128, (layers, k, n), generator=gen, device=device,
                       dtype=torch.int8)
    sc = torch.empty((layers, k // g, n), device=device).uniform_(1e-3, 2e-2, generator=gen)
    b = torch.empty((layers, k // g, n), device=device).uniform_(-0.1, 0.0, generator=gen)
    return qs, sc.to(torch.bfloat16), b.to(torch.bfloat16)


def rand_i8p(gen: torch.Generator, layers: int, n: int, k: int, device):
    """Stacked random int8 prefill companions: (w8 int8 [L, N, K], sw f32
    [L, K/256, N]), the layout of ops.repack.I8PQTensor."""
    w8 = torch.randint(-127, 128, (layers, n, k), generator=gen, device=device,
                       dtype=torch.int8)
    sw = torch.empty((layers, k // 256, n), device=device).uniform_(1e-4, 2e-4, generator=gen)
    return w8, sw


def i8p_fault(xq, sxa, w8, sw):
    """A faulty int8 prefill, the control that qmm_i8p's tolerance must
    reject: the weight scales of the first two 256-blocks swapped."""
    from .ops.qmatmul import qmm_i8p_plain
    order = torch.arange(sw.shape[0], device=sw.device)
    order[:2] = torch.tensor([1, 0])
    return qmm_i8p_plain(xq, sxa, w8, sw[order])


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's use_more_bits (its quantizer's llama_tensor_get_type):
    the layers of n that a Q4_K_M file stores attn_v and ffn_down of in
    Q6_K: the first and last eighth, and every third layer between."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def make_q4_k_m_llama(preset: str = "llama3-8b", seed: int = 0, device="cuda",
                      n_layers=None):
    """(cfg, params) of a synthetic model by llama.cpp's Q4_K_M recipe
    (llama_tensor_get_type), random weights from a seed (models.synthetic),
    fused as the loader fuses them:
      - ffn_down Q6_K in the layers where use_more_bits(i, n), in a MoE
        model every expert's;
      - attn_v Q6_K in those layers, except that a model of 8 experts has
        attn_k and attn_v Q8_0 and attn_output Q5_K in every layer;
      - every other matrix Q4_K, a MoE router dense, the output head Q6_K.
    The layers differ in format, so the params stay a list (the unrolled
    forward). Layers that share buffers in the preset (share_layers) share
    them again within each of the two formats. n_layers cuts the preset's
    depth (make_synthetic_llama)."""
    import dataclasses
    from .models.loader import fuse_projections
    from .models.synthetic import _rand_qtensor, make_synthetic_llama
    from .ops.repack import expert_slice, stack_experts
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=seed, device=device,
                                       n_layers=n_layers)
    gen = torch.Generator(device=params.tok_embd.device)
    gen.manual_seed(seed + 1)
    dev = params.tok_embd.device
    rq = lambda n, k, quant: _rand_qtensor(gen, n, k, quant, dev)
    d, dff, n_e = cfg.d_model, cfg.d_ff, cfg.n_experts
    nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    made, layers = {}, []
    for i, l in enumerate(params.layers):
        more = use_more_bits(i, cfg.n_layers)
        if (id(l), more) not in made:
            kw = {}
            if n_e == 8:
                kw.update(wk=rq(nkv, d, "Q8_0"), wv=rq(nkv, d, "Q8_0"), wo=rq(d, nq, "Q5_K"))
            elif more:
                kw["wv"] = rq(nkv, d, "Q6_K")
            if n_e:
                ex = {f"{r}.{e}": expert_slice(l.experts[r], e)
                      for r in ("gate", "up", "down") for e in range(n_e)}
                if more:
                    ex.update({f"down.{e}": rq(d, dff, "Q6_K") for e in range(n_e)})
                kw["experts"] = stack_experts(ex, n_e, fuse_gate_up=True)
            elif more:
                kw["w_down"] = rq(d, dff, "Q6_K")
            made[(id(l), more)] = dataclasses.replace(l, **kw)
        layers.append(made[(id(l), more)])
    params = dataclasses.replace(params, layers=layers,
                                 output=rq(cfg.n_vocab, d, "Q6_K"))
    return cfg, fuse_projections(params, cfg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the tensor, in units of max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over rows (every index but the last) of max |got - want|
    within the row, in units of that row's max |want|. For attention a row
    is one query's output for one head, so a fault in a few rows is not
    hidden behind the largest output of the tensor."""
    err = (got.float() - want.float()).abs().amax(-1)
    return (err / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def flash_prefill_tile_fault(q, k, v, scale: float, tile: int = 64):
    """A faulty causal attention, the control that the flash prefill's
    tolerance must reject: each query past the first `tile` rows loses the
    keys of its own diagonal tile before itself, as a kernel that skipped
    the diagonal tile would (the query's own key is kept, so every row stays
    finite). Otherwise the numerics of flash_prefill_plain."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    bf = lambda a: a.to(torch.bfloat16).float()
    s = torch.einsum("bthgd,bshd->bhgts",
                     bf(q).reshape(b, t, hkv, hq // hkv, d), bf(k)) * scale
    i = torch.arange(t, device=q.device)
    keep = i[None, :] <= i[:, None]
    own_tile = (i[None, :] // tile == i[:, None] // tile) & (i[None, :] < i[:, None])
    keep &= ~(own_tile & (i[:, None] >= tile))
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhgts,bshd->bhgtd", bf(p), bf(v))
    out = bf(acc / p.sum(-1, keepdim=True))
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d)


def _swap_lo_hi(scales):
    """q4b scales [K/32, Ns] with each superblock's lo and hi rows swapped."""
    g, ns = scales.shape
    return scales.reshape(g // 8, 2, 4, ns).flip(1).reshape(g, ns)


def planes_fault(x, qs, scales):
    """A faulty two-plane product, the control that qmm_planes' tolerance
    must reject: each superblock's lo and hi scale rows swapped."""
    from .ops.qmatmul import qmm_planes_plain
    return qmm_planes_plain(x, qs, _swap_lo_hi(scales))


def q4b_scale_swap(xq, sx, qs, scales):
    """A faulty int8-flavour q4b product, the control that qmm_int8's
    tolerance must reject: each superblock's lo and hi scale rows swapped."""
    from .ops.qmatmul import qmm_int8_plain
    return qmm_int8_plain(xq, sx, qs, _swap_lo_hi(scales))


def txn_scale_swap(xq, sx, qs, scales, bias):
    """A faulty q4b product, the control that qmm_txn's tolerance must
    reject: each superblock's lo and hi scale rows swapped, the bias kept."""
    from .ops.qmatmul import qmm_txn_plain
    return qmm_txn_plain(xq, sx, qs, _swap_lo_hi(scales), bias)


def paged_case(gen: torch.Generator, lengths, hq: int, hkv: int, d: int,
               ps: int, maxp: int, n_layers: int = 1, int8: bool = False,
               device="cpu", dtype=torch.bfloat16):
    """Random inputs of paged attention over a pool of n_layers layers:
    (q f32 [R, Hq, D], k_pages, v_pages [L, Hkv, P, ps, D] of dtype or int8,
    k_scale, v_scale [L, Hkv, P, ps, 1] f32 or None, lengths int32 [R],
    tables int32 [R, maxp]). The pool has 1 + R*maxp pages; each row's
    pages are drawn from a random permutation of pages 1.. (page 0 is the
    trash page, left in unused table entries), so a kernel that read the
    pages in order would read another row's."""
    r = len(lengths)
    n_pages = 1 + r * maxp
    q = torch.randn((r, hq, d), generator=gen, device=device) * d ** -0.5
    shape = (n_layers, hkv, n_pages, ps, d)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=device,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.empty(shape[:-1] + (1,), device=device).uniform_(
            2e-3, 2e-2, generator=gen) for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=gen, device=device).to(dtype)
                  for _ in range(2))
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=gen, device=device) + 1
    tables = torch.zeros((r, maxp), dtype=torch.int32, device=device)
    for i, n in enumerate(lengths):
        used = -(-int(n) // ps)
        tables[i, :used] = perm[i * maxp:i * maxp + used].to(torch.int32)
    lens = torch.tensor(list(lengths), dtype=torch.int32, device=device)
    return q, kp, vp, ks, vs, lens, tables


def paged_controls(q, kp, vp, ks, vs, lengths, tables, ps: int):
    """The two faulty paged attentions that the kernel's tolerance must
    reject, from the plain version: (one masked key made visible: lengths
    + 1; each row's last page dropped from its table: that entry sent to
    the trash page 0)."""
    from .ops.attention import paged_attention_plain
    more = paged_attention_plain(q, kp, vp, lengths + 1, tables, ks, vs)
    dropped = tables.clone()
    rows = torch.arange(tables.shape[0], device=tables.device)
    dropped[rows, ((lengths.long() - 1) // ps)] = 0
    return more, paged_attention_plain(q, kp, vp, lengths, dropped, ks, vs)


# flash_decode_write's schedule constants, mirrored from
# csrc/flash_decode_write.cu (NW) and csrc/decode_cluster.cuh (RW, CS;
# fdw_rank_ranges is its rank_lo):
# change both together
FDW_SLAB = 16          # rows a warp takes at a time
FDW_WARPS = 4          # warps of one block
FDW_CLUSTER = 8        # blocks of one cluster, one cluster per (batch row, kv head)


def fdw_rank_ranges(n_vis: int, cs: int):
    """The rows [lo, hi) that each rank of flash_decode_write's cluster of
    cs blocks takes of the n_vis visible rows: lo = r * n_vis // cs, the
    kernel's rank_lo. Fixed by (n_vis, cs) alone."""
    return [(r * n_vis // cs, (r + 1) * n_vis // cs) for r in range(cs)]


def fdw_split_emulate(q, k3, v3, k_new, v_new, li: int, pos, scale: float,
                      hkv: int, s_eff: int, cs: int, drop_rank=None, win_l=None,
                      softcap: float = 0.0):
    """flash_decode_write's schedule in PyTorch, for the CPU tests (nothing
    of the model path calls it). For each batch row and kv head: the
    visible rows are [vis_lo, min(pos, s_eff)), vis_lo = max(0, pos - win_l
    + 1) under a window (else 0); rank r of the cluster takes its
    fdw_rank_ranges rows of them; every score (the new token's too) is
    softcapped when softcap > 0; warp w of the rank takes
    the 16-row slabs w, w + 4, ... with one max and one rescale of acc a
    slab (q and p rounded to bf16, l summing the f32 p); the warps'
    partials merge in warp order, the ranks' in rank order with the new
    token (f32 k, v) last; out / max(l, 1e-30). Writes the new rows in
    place, as the kernel does. drop_rank: that rank's partial is left
    neutral (m = -1e30, l = 0), the control that the kernel's tolerance
    must reject."""
    b, hq, d = q.shape
    g = hq // hkv
    bf = lambda a: a.to(torch.bfloat16).float()
    cap = (lambda s: softcap * torch.tanh(s / softcap)) if softcap else (lambda s: s)
    neg = torch.tensor(NEG_INF)
    out = torch.empty((b, hkv, g, d))
    for bi in range(b):
        qb = bf(q[bi].float()).reshape(hkv, g, d)
        vis_lo = max(0, int(pos[bi]) - win_l + 1) if win_l else 0
        n_vis = max(0, min(int(pos[bi]), s_eff) - vis_lo)
        kc = k3[li, bi, vis_lo:vis_lo + n_vis].float().reshape(n_vis, hkv, d)
        vc = v3[li, bi, vis_lo:vis_lo + n_vis].float().reshape(n_vis, hkv, d)
        ranks = []
        for r, (lo, hi) in enumerate(fdw_rank_ranges(n_vis, cs)):
            warps = []
            for w in range(FDW_WARPS):
                m = torch.full((hkv, g), NEG_INF)
                l = torch.zeros((hkv, g))
                acc = torch.zeros((hkv, g, d))
                if r != drop_rank:
                    for j0 in range(lo + FDW_SLAB * w, hi, FDW_SLAB * FDW_WARPS):
                        j1 = min(j0 + FDW_SLAB, hi)
                        s = cap(torch.einsum("hgd,jhd->hgj", qb, kc[j0:j1]) * scale)
                        mn = torch.maximum(m, s.amax(-1))
                        corr = torch.exp(m - mn)
                        p = torch.exp(s - mn[..., None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[..., None] + torch.einsum("hgj,jhd->hgd", bf(p),
                                                                   vc[j0:j1])
                        m = mn
                warps.append((m, l, acc))
            mx = torch.stack([wm for wm, _, _ in warps]).amax(0)
            l_r = torch.zeros((hkv, g))
            acc_r = torch.zeros((hkv, g, d))
            for wm, wl, wacc in warps:
                f = torch.exp(wm - mx)
                l_r = l_r + wl * f
                acc_r = acc_r + wacc * f[..., None]
            ranks.append((mx, l_r, acc_r))
        kn = k_new[bi].float().reshape(hkv, d)
        vn = v_new[bi].float().reshape(hkv, d)
        sn = cap(torch.einsum("hgd,hd->hg", qb, kn) * scale)
        mx = torch.maximum(torch.stack([rm for rm, _, _ in ranks]).amax(0)
                           if ranks else neg, sn)
        lsum = torch.zeros((hkv, g))
        asum = torch.zeros((hkv, g, d))
        for rm, rl, racc in ranks:
            w = torch.exp(rm - mx)
            lsum = lsum + rl * w
            asum = asum + racc * w[..., None]
        pn = torch.exp(sn - mx)
        out[bi] = (asum + pn[..., None] * vn[:, None, :]) / torch.clamp(
            lsum + pn, min=1e-30)[..., None]
    rows = torch.arange(b)
    k3[li, rows, pos.long()] = k_new.reshape(b, -1).to(k3.dtype)
    v3[li, rows, pos.long()] = v_new.reshape(b, -1).to(v3.dtype)
    return out.reshape(b, hq, d)


# paged_attention's schedule constants, mirrored from csrc/paged_attention.cu
# (Ring::NW) and csrc/decode_cluster.cuh (RQ, CS; pa_rank_ranges is its
# rank_lo over the clamped length): change both together
PA_SLAB = 32           # keys a warp takes at a time: one a lane
PA_WARPS = 4           # warps of one block
PA_CLUSTER = 8         # blocks of one cluster, one cluster per (row, kv head, chunk)


def pa_rank_ranges(length: int, ps: int, maxp: int, cs: int = PA_CLUSTER):
    """The keys [lo, hi) of a row that each rank of paged_attention's
    cluster takes: the row's n = min(length, maxp * ps) visible keys split
    by fdw_rank_ranges (the kernel's rank_lo), read on the device from
    lengths alone."""
    return fdw_rank_ranges(max(0, min(int(length), maxp * ps)), cs)


def pa_slabs(lo: int, hi: int):
    """The slabs [(j0, j1)] of each warp of a rank over its keys [lo, hi):
    warp w takes the PA_SLAB-key slabs w, w + PA_WARPS, ..."""
    return [[(j0, min(j0 + PA_SLAB, hi)) for j0 in range(lo + PA_SLAB * w, hi,
                                                           PA_SLAB * PA_WARPS)]
            for w in range(PA_WARPS)]


def pa_rank_pages(lo: int, hi: int, ps: int):
    """The table entries [p0, p0 + np) that a rank stages for its keys
    [lo, hi), as the kernel does before its first copy."""
    return (lo // ps, (hi - 1) // ps - lo // ps + 1) if hi > lo else (lo // ps, 0)


def pa_split_emulate(q, k_pages_l, v_pages_l, lengths, tables, k_scale_l=None,
                     v_scale_l=None, cs: int = PA_CLUSTER, drop_rank=None):
    """paged_attention's schedule in PyTorch, for the CPU tests (nothing of
    the model path calls it). For each row and kv head, all in f32: rank r
    of the cluster takes its pa_rank_ranges keys, each found at page
    tables[row, j // ps], offset j % ps; warp w of the rank takes its
    pa_slabs with one max and one rescale of acc a slab; the warps'
    partials merge in warp order, the ranks' in rank order; out / max(l,
    1e-30). drop_rank: that rank's partial is left neutral (m = -1e30, l =
    0), the control that the kernel's tolerance must reject."""
    r, hq, d = q.shape
    hkv, _, ps, _ = k_pages_l.shape
    g = hq // hkv
    maxp = tables.shape[1]

    def merge(parts):
        mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
        l_sum = torch.zeros((hkv, g))
        a_sum = torch.zeros((hkv, g, d))
        for pm, pl, pa in parts:
            f = torch.exp(pm - mx)
            l_sum = l_sum + pl * f
            a_sum = a_sum + pa * f[..., None]
        return mx, l_sum, a_sum

    out = torch.empty((r, hkv, g, d))
    for ri in range(r):
        qg = q[ri].float().reshape(hkv, g, d)
        ranks = []
        for rk, (lo, hi) in enumerate(pa_rank_ranges(int(lengths[ri]), ps, maxp, cs)):
            warps = []
            for slabs in pa_slabs(lo, hi):
                m = torch.full((hkv, g), NEG_INF)
                l = torch.zeros((hkv, g))
                acc = torch.zeros((hkv, g, d))
                for j0, j1 in ([] if rk == drop_rank else slabs):
                    j = torch.arange(j0, j1)
                    pg, off = tables[ri, j // ps].long(), j % ps
                    kk = k_pages_l[:, pg, off].float()             # [Hkv, n, D]
                    vv = v_pages_l[:, pg, off].float()
                    if k_scale_l is not None:
                        kk = kk * k_scale_l[:, pg, off]
                        vv = vv * v_scale_l[:, pg, off]
                    s = torch.einsum("hgd,hjd->hgj", qg, kk)
                    mn = torch.maximum(m, s.amax(-1))
                    corr = torch.exp(m - mn)
                    p = torch.exp(s - mn[..., None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum("hgj,hjd->hgd", p, vv)
                    m = mn
                warps.append((m, l, acc))
            ranks.append(merge(warps))
        _, l_all, a_all = merge(ranks)
        out[ri] = a_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(r, hq, d)
