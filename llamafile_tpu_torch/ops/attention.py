"""Attention paths of the port: fused decode with the KV-row write, and the
causal prefill over fresh prompt tokens.

Counterpart of llamafile_tpu/ops/attention.py for what the port reaches:

  flash_decode_write_stacked <- _flash_decode_write_kernel (kernel
      flash_decode_write, csrc/flash_decode_write.cu): T = 1 GQA attention
      over layer li of the flat [L, B, S, Hkv*D] bf16 cache, with the new
      row written in place at pos.
  flash_prefill <- the upstream Pallas flash_attention (kernel
      flash_prefill, csrc/flash_prefill.cu) for T >= 128, T % 128 == 0,
      D in (64, 128, 256), no window and no softcap, in its numerics; the
      f32 einsum otherwise (the reference's routing).
  paged_attention <- the upstream Pallas paged_attention that
      llamafile_tpu/runtime/paged.py paged_attend calls (kernel
      paged_attention, csrc/paged_attention.cu): batched T = 1 GQA
      attention over block tables, bf16 or int8 pages, all in f32.
  flash_decode, flash_decode_stacked <- _flash_decode_kernel and
      _flash_decode_qt_kernel (kernel flash_decode, csrc/flash_decode.cu):
      T = 1 GQA attention over one layer of a dense cache, bf16 or int8
      codes with f32 scales, read in place.

Decode attention routes by shape as the reference does, on every device and
before any launch (decode_route): a dense cache takes the f32 einsum for
S % 256, D % 128 or Hq > 256, a paged pool the gather for D % 128 or a v
width other than D; the kernel otherwise (its plain version for CPU
tensors). ROUTE_COUNTS counts the einsum and gather calls, as `.launches`
counts each kernel's. The three decode kernels take every head group G =
Hq / Hkv at D = 128, as the reference's kernels do: a group of up to 8
query heads is one chunk of a kernel's work, a larger one head_chunks(G)
chunks on the grid, each reading its K/V rows again.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._build import F, I, L, P

NEG_INF = -1e30


def _use_flash(t: int, d: int) -> bool:
    """The reference's routing (llamafile_tpu/ops/attention.py _use_flash)."""
    return t >= 128 and t % 128 == 0 and d in (64, 128, 256)


FLASH_BLOCK = 256                   # the reference's block_q = block_k
ROUTE_COUNTS = {"einsum": 0, "gather": 0}


def decode_route(d: int, *, hq: int = 0, s_eff: int = 0, dv: Optional[int] = None,
                 paged: bool = False) -> str:
    """The route of a decode attention shape, the reference's choice:
    "kernel", or its own non-kernel branch, "einsum" for a dense cache of
    s_eff positions (llamafile_tpu/ops/attention.py:334-342: S % 256,
    D % 128 or Hq > 256) and "gather" for a paged pool
    (llamafile_tpu/runtime/paged.py:262-300: D % 128 or a v width dv != D)."""
    if paged:
        return "gather" if d % 128 or (dv is not None and dv != d) else "kernel"
    return "einsum" if s_eff % 256 or d % 128 or hq > 256 else "kernel"


def head_chunks(g: int) -> int:
    """The chunks a decode kernel splits a group of g query heads into: one
    for g <= 8, else ceil(g / 8) of ceil(g / chunks) heads each (the C
    entries compute the same)."""
    return -(-g // 8)


def _check_group(what: str, d: int, hq: int, hkv: int, dk: Optional[int] = None) -> None:
    """The decode kernels' domain: D = 128 (and a cache of the same width)
    and Hq a multiple of Hkv; raises ValueError outside it."""
    if d != 128 or (dk is not None and dk != d) or hkv < 1 or hq % hkv:
        raise ValueError(f"{what} takes D=128 and Hq a multiple of Hkv, got D={d}"
                         + ("" if dk is None else f" (cache {dk})")
                         + f", Hq={hq}, Hkv={hkv}")


_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)   # upstream's


def flash_prefill_plain(q, k, v, scale: float):
    """Plain version of the flash_prefill kernel, in the upstream Pallas
    flash_attention's numerics at the reference's 256-wide blocks: q, k, v
    rounded to bf16; f32 scores scaled after the dot, the causal mask added
    as -0.7 * f32 max. Within one key block (T <= 256, the upstream
    single-step kernel) p is normalized by l before its bf16 rounding; over
    several, each query block runs the upstream online softmax over the key
    blocks on or below its diagonal (running max, bf16 p, acc rescaled by
    l_corr / l_next and P.V added times 1 / l_next). The output is rounded
    to bf16 (q's dtype there) and returned as f32."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    bf = lambda a: a.to(torch.bfloat16).float()
    qg = bf(q).reshape(b, t, hkv, hq // hkv, d)
    vb = bf(v)
    s = torch.einsum("bthgd,bshd->bhgts", qg, bf(k)) * scale
    i = torch.arange(t, device=q.device)
    s = s + torch.where(i[None, :] <= i[:, None], 0.0, _MASK_VALUE)
    blk = min(FLASH_BLOCK, t)
    if t == blk:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        acc = torch.einsum("bhgts,bshd->bhgtd", bf(p), vb)
    else:
        acc = torch.empty(s.shape[:-1] + (d,), device=q.device)
        for q0 in range(0, t, blk):
            m = torch.full(s.shape[:-2] + (min(blk, t - q0), 1), float("-inf"),
                           device=q.device)
            l = torch.zeros_like(m)
            a = torch.zeros(m.shape[:-1] + (d,), device=q.device)
            for k0 in range(0, q0 + blk, blk):
                sb = s[..., q0:q0 + blk, k0:k0 + blk]
                m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
                p = torch.exp(sb - m_next)
                l_corr = torch.exp(m - m_next) * l
                l_next = p.sum(-1, keepdim=True) + l_corr
                inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
                a = a * (l_corr * inv) + torch.einsum(
                    "bhgts,bshd->bhgtd", bf(p), vb[:, k0:k0 + blk]) * inv
                m, l = m_next, l_next
            acc[..., q0:q0 + blk, :] = a
    out = bf(acc)                                           # [B, Hkv, G, T, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d)


def flash_prefill(q, k, v, scale: float, window=None, softcap: float = 0.0):
    """Causal self-attention over fresh prompt tokens.

    q: [B, T, Hq, D]; k, v: [B, T, Hkv, D]. Returns [B, T, Hq, D] f32.
    T >= 128 (multiple of 128, D 64/128/256) without window or softcap runs
    the flash_prefill kernel (its plain version for CPU tensors); every
    other case runs the f32 einsum, as the reference does."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if window is None and not softcap and _use_flash(t, d):
        if q.device.type == "cpu":
            return flash_prefill_plain(q, k, v, scale)
        if hq % hkv:
            raise ValueError(f"flash_prefill: Hq={hq} is not a multiple of Hkv={hkv}")
        qb, kb, vb = (a.to(torch.bfloat16).contiguous() for a in (q, k, v))
        for name, a in (("k", kb), ("v", vb)):
            if a.device != q.device or a.shape != (b, t, hkv, d):
                raise ValueError(f"flash_prefill: {name} {tuple(a.shape)} on "
                                 f"{a.device} does not match q {tuple(q.shape)}")
        out = torch.empty((b, t, hq, d), dtype=torch.float32, device=q.device)
        f = _build.fn("flash_prefill", "flash_prefill", [P] * 4 + [I] * 5 + [F, P])
        _build.check(f(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                       out.data_ptr(), b, t, hq, hkv, d, float(scale),
                       torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_prefill")
        flash_prefill.launches += 1
        return out
    group = hq // hkv
    qg = q.reshape(b, t, hkv, group, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (j > i - window)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(b, t, hq, d)


flash_prefill.launches = 0


def flash_decode_write_plain(q, k3, v3, k_new, v_new, li: int, pos,
                             scale: float, hkv: int, s_eff: int,
                             win_l=None, softcap: float = 0.0):
    """Plain version of the flash_decode_write kernel, in its numerics: q in
    bf16, f32 scores, bf16 p before P.V (l sums the f32 p), cache rows
    j <= pos-1 (and inside the window), the f32 new token merged last, out
    divided by max(l, 1e-30). Writes the new rows into k3/v3 in place."""
    b, hq, d = q.shape
    group = hq // hkv
    qb = q.to(torch.bfloat16).float().reshape(b, hkv, group, d)
    kc = k3[li, :, :s_eff].float().reshape(b, s_eff, hkv, d)
    vc = v3[li, :, :s_eff].float().reshape(b, s_eff, hkv, d)
    kn = k_new.float().reshape(b, hkv, d)
    vn = v_new.float().reshape(b, hkv, d)
    s = torch.einsum("bhgd,bshd->bhgs", qb, kc) * scale
    sn = torch.einsum("bhgd,bhd->bhg", qb, kn) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
        sn = softcap * torch.tanh(sn / softcap)
    j = torch.arange(s_eff, device=q.device)
    p_ = pos.to(q.device).long()[:, None]
    vis = j[None, :] <= p_ - 1
    if win_l is not None:
        vis = vis & (j[None, :] > p_ - win_l)
    s = torch.where(vis[:, None, None, :], s, torch.full_like(s, NEG_INF))
    mx = torch.maximum(s.amax(dim=-1), sn)                       # [B, H, G]
    p = torch.where(vis[:, None, None, :], torch.exp(s - mx[..., None]),
                    torch.zeros_like(s))
    pn = torch.exp(sn - mx)
    l = p.sum(-1) + pn
    acc = (torch.einsum("bhgs,bshd->bhgd", p.to(torch.bfloat16).float(), vc)
           + pn[..., None] * vn[:, :, None, :])
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(b, hq, d)
    rows = torch.arange(b, device=q.device)
    k3[li, rows, pos.long()] = k_new.reshape(b, -1).to(k3.dtype)
    v3[li, rows, pos.long()] = v_new.reshape(b, -1).to(v3.dtype)
    return out


def flash_decode_write_stacked(q, k3, v3, k_new, v_new, li: int, pos,
                               scale: float, hkv: int,
                               s_limit: Optional[int] = None, win_l=None,
                               softcap: float = 0.0):
    """Decode attention (T = 1) with the fused cache-row write.

    q [B, Hq, D] f32; k3/v3 [L, B, S, Hkv*D] bf16, updated IN PLACE at
    [li, b, pos[b]] (the JAX package donated and aliased these buffers);
    k_new/v_new [B, Hkv, D] roped new rows; li a Python int; pos int32 [B]
    on the cache's device. s_limit bounds the streamed positions (the
    attn_len bucket). Shapes of the einsum route (decode_route) write the
    rows, then run flash_decode_stacked, as the reference does. On the card
    a call is one launch of B * Hkv * head_chunks(Hq / Hkv) thread-block
    clusters of 8 blocks, with no scratch in device memory. Returns attn
    [B, Hq, D] f32."""
    b, hq, d = q.shape
    n_l, _, s_len, _ = k3.shape
    s_eff = s_limit if s_limit is not None and s_limit < s_len else s_len
    if decode_route(d, hq=hq, s_eff=s_eff) == "einsum":
        rows = torch.arange(b, device=q.device)
        k3[li, rows, pos.long()] = k_new.reshape(b, -1).float().to(k3.dtype)
        v3[li, rows, pos.long()] = v_new.reshape(b, -1).float().to(v3.dtype)
        return flash_decode_stacked(q, k3, v3, li, pos, scale, hkv, s_limit, win_l,
                                    softcap)
    if q.device.type == "cpu":
        return flash_decode_write_plain(q, k3, v3, k_new, v_new, li, pos,
                                        scale, hkv, s_eff, win_l, softcap)
    if win_l is not None or softcap:
        raise NotImplementedError(
            "the sliding window and softcap of _flash_decode_write_kernel are "
            "not in the CUDA kernel yet")
    _check_group("flash_decode_write", d, hq, hkv)
    qf = q.float().contiguous()
    kn = k_new.float().reshape(b, hkv * d).contiguous()
    vn = v_new.float().reshape(b, hkv * d).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    for name, t in (("k3", k3), ("v3", v3), ("pos", pos32), ("q", qf)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k3.dtype != torch.bfloat16 or v3.dtype != torch.bfloat16 \
            or not k3.is_contiguous() or not v3.is_contiguous() \
            or k3.shape != v3.shape or k3.shape[-1] != hkv * d \
            or k3.shape[1] != b or not 0 <= li < n_l:
        raise ValueError("caches must be contiguous bf16 [L, B, S, Hkv*D] "
                         "matching q and li")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    f = _build.fn("flash_decode_write", "flash_decode_write",
                  [P] * 7 + [I] * 6 + [F, P])
    _build.check(f(qf.data_ptr(), k3.data_ptr(), v3.data_ptr(), kn.data_ptr(),
                   vn.data_ptr(), pos32.data_ptr(), out.data_ptr(), li, b,
                   s_len, hq, hkv, s_eff, float(scale),
                   torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_decode_write")
    flash_decode_write_stacked.launches += 1
    return out


flash_decode_write_stacked.launches = 0


def flash_decode_plain(q, k, v, pos, scale: float, window: int = 0,
                       softcap: float = 0.0, k_scale=None, v_scale=None):
    """Plain version of the flash_decode kernel, in its numerics: a bf16
    cache rounds q and p to bf16 (l sums the f32 p); an int8 cache (codes
    with k_scale/v_scale) or an f32 one computes in f32 on the dequantized
    K/V. f32 scores times scale, -1e30 mask of keys j > pos (and j <=
    pos - window), softmax over all keys at once, out / max(l, 1e-30)."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    rnd = ((lambda a: a.to(torch.bfloat16).float()) if k.dtype == torch.bfloat16
           else (lambda a: a.float()))
    qg = rnd(q).reshape(b, hkv, hq // hkv, d)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    j = torch.arange(s, device=q.device)[None, :]
    p_ = pos.to(q.device).long()[:, None]
    vis = j <= p_
    if window:
        vis = vis & (j > p_ - window)
    sc = torch.where(vis[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhgs,bshd->bhgd", rnd(p), v.float())
    return (acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]).reshape(b, hq, d)


def flash_decode_stacked_plain(q, k3, v3, li: int, pos, scale: float, hkv: int,
                               s_eff: int, win_l=None, softcap: float = 0.0):
    """Plain version of flash_decode_stacked: flash_decode_plain on the first
    s_eff positions of layer li of the flat [L, B, S, Hkv*D] cache."""
    b, _, d = q.shape
    kc = k3[li, :, :s_eff].reshape(b, s_eff, hkv, d)
    vc = v3[li, :, :s_eff].reshape(b, s_eff, hkv, d)
    return flash_decode_plain(q, kc, vc, pos, scale, win_l or 0, softcap)


def _decode_einsum(q, k, v, pos, scale, window, softcap):
    """The reference's decode route for shapes its kernel does not take
    (S % 256, D % 128, Hq > 256): the f32 einsum attention."""
    from ..models.llama import attention
    ROUTE_COUNTS["einsum"] += 1
    return attention(q[:, None], k, v, pos, torch.arange(1, device=q.device),
                     scale, window=window or None, softcap=softcap)[:, 0]


def _flash_decode_launch(q, k, v, k_scale, v_scale, pos, scale: float,
                         window: int, softcap: float):
    """Launch the flash_decode kernel on k, v [B, s_eff, Hkv, D] views whose
    last three axes are contiguous (a slice of a layer of the cache: the
    kernel reads it in place), bf16, or int8 with [B, s_eff, Hkv] f32
    scales."""
    if softcap:
        raise NotImplementedError("the softcap of _flash_decode_kernel is not "
                                  "in the CUDA kernel yet")
    b, hq, d = q.shape
    _, s_eff, hkv, dk = k.shape
    quant = k_scale is not None
    _check_group("flash_decode", d, hq, hkv, dk)
    qf = q.float().contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    cache_t = torch.int8 if quant else torch.bfloat16
    named = [("k", k, cache_t, (hkv * d, d, 1)), ("v", v, cache_t, (hkv * d, d, 1))]
    if quant:
        named += [("k_scale", k_scale, torch.float32, (hkv, 1)),
                  ("v_scale", v_scale, torch.float32, (hkv, 1))]
    elif v_scale is not None:
        raise ValueError("v_scale given without k_scale")
    for name, t, dt, inner in named:
        if t.device != q.device or t.dtype != dt or tuple(t.shape[:2]) != (b, s_eff) \
                or t.stride()[1:] != inner:
            raise ValueError(f"flash_decode: {name} must be a {dt} [B, S, Hkv(, D)] "
                             f"view with contiguous inner axes on {q.device}")
    if v.stride(0) != k.stride(0) or (quant and v_scale.stride(0) != k_scale.stride(0)):
        raise ValueError("flash_decode: k and v (and their scales) differ in batch stride")
    if pos32.device != q.device or pos32.shape != (b,):
        raise ValueError(f"flash_decode: pos must be int32 [{b}] on {q.device}")
    # splits of 16 positions or more, enough to fill the SMs a few blocks deep
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    blocks = b * hkv * head_chunks(hq // hkv)            # a split's blocks
    per_split = -(-s_eff // max(1, -(-4 * sms // blocks)))
    chunk = max(16, -(-per_split // 16) * 16)
    n_split = -(-s_eff // chunk)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    m_part = torch.empty((b, hq, n_split), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, hq, n_split, d), dtype=torch.float32, device=q.device)
    f = _build.fn("flash_decode", "flash_decode",
                  [P] * 10 + [I] * 4 + [L, L] + [I] * 4 + [F, P])
    _build.check(f(qf.data_ptr(), k.data_ptr(), v.data_ptr(),
                   k_scale.data_ptr() if quant else None,
                   v_scale.data_ptr() if quant else None, pos32.data_ptr(),
                   out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                   acc_part.data_ptr(), b, hq, hkv, s_eff, k.stride(0),
                   k_scale.stride(0) if quant else 0, int(window or 0), chunk,
                   n_split, int(quant), float(scale),
                   torch.cuda.current_stream(q.device).cuda_stream), "flash_decode")
    flash_decode.launches += 1
    return out


def flash_decode(q, k, v, pos, scale: float, window: int = 0,
                 softcap: float = 0.0, k_scale=None, v_scale=None):
    """Decode attention (T = 1) of one layer of a dense cache.

    q [B, Hq, D] f32; k, v [B, S, Hkv, D] bf16, or int8 codes with k_scale,
    v_scale [B, S, Hkv] f32 (the reference's f32 dequantized K/V, computed
    in the kernel's registers); views of a cache layer are read in place.
    pos int32 [B] is each row's last visible index. Returns [B, Hq, D] f32.
    The reference's routing: S % 256, D % 128 or Hq > 256 take the f32
    einsum; otherwise the flash_decode kernel, its plain version for CPU
    tensors."""
    b, hq, d = q.shape
    s = k.shape[1]
    if decode_route(d, hq=hq, s_eff=s) == "einsum":
        if k_scale is not None:
            k, v = k.float() * k_scale[..., None], v.float() * v_scale[..., None]
        return _decode_einsum(q, k, v, pos, scale, window, softcap)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, scale, window, softcap,
                                  k_scale, v_scale)
    return _flash_decode_launch(q, k, v, k_scale, v_scale, pos, scale, window,
                                softcap)


flash_decode.launches = 0


def flash_decode_stacked(q, k3, v3, li: int, pos, scale: float, hkv: int,
                         s_limit: Optional[int] = None, win_l=None,
                         softcap: float = 0.0):
    """Decode attention (T = 1) over layer li (a Python int) of the flat
    [L, B, S, Hkv*D] bf16 cache, streaming its first s_limit positions (all
    when None). The flash_decode kernel reads layer li in place (the TPU's
    layer-indexed _flash_decode_qt_kernel); the reference's routing as in
    flash_decode. Returns [B, Hq, D] f32."""
    b, hq, d = q.shape
    s_len = k3.shape[2]
    s_eff = s_limit if s_limit is not None and s_limit < s_len else s_len
    kc = k3[li, :, :s_eff].reshape(b, s_eff, hkv, d)
    vc = v3[li, :, :s_eff].reshape(b, s_eff, hkv, d)
    if decode_route(d, hq=hq, s_eff=s_eff) == "einsum":
        return _decode_einsum(q, kc, vc, pos, scale, win_l, softcap)
    if q.device.type == "cpu":
        return flash_decode_stacked_plain(q, k3, v3, li, pos, scale, hkv, s_eff,
                                          win_l, softcap)
    return _flash_decode_launch(q, kc, vc, None, None, pos, scale, win_l or 0,
                                softcap)


def paged_gather(q, k_pages_l, v_pages_l, lengths, tables, k_scale_l=None,
                 v_scale_l=None):
    """The reference's gather route of paged decode attention
    (llamafile_tpu/runtime/paged.py:281-300), taken by shape (decode_route):
    every table entry's page is gathered, keys j >= lengths[r] are masked,
    f32 softmax. The paged_attention kernel computes the same function, so
    this is also its plain version (paged_attention_plain)."""
    r, hq, d = q.shape
    hkv, _, ps, _ = k_pages_l.shape
    dv = v_pages_l.shape[-1]
    maxp = tables.shape[1]
    t = tables.long()
    k = k_pages_l[:, t]                                   # [Hkv, R, MAXP, ps, D]
    v = v_pages_l[:, t]
    if k_scale_l is not None:
        k = k.float() * k_scale_l[:, t]
        v = v.float() * v_scale_l[:, t]
    k = k.permute(1, 0, 2, 3, 4).reshape(r, hkv, maxp * ps, d).float()
    v = v.permute(1, 0, 2, 3, 4).reshape(r, hkv, maxp * ps, dv).float()
    qg = q.reshape(r, hkv, hq // hkv, d).float()
    scores = torch.einsum("rhgd,rhsd->rhgs", qg, k)
    j = torch.arange(maxp * ps, device=q.device)[None, :]
    mask = j < lengths.to(q.device).long()[:, None]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    out = torch.einsum("rhgs,rhsd->rhgd", torch.softmax(scores, dim=-1), v)
    return out.reshape(r, hq, dv)


paged_attention_plain = paged_gather


def paged_attention(q, k_pages_l, v_pages_l, lengths, tables,
                    k_scale_l=None, v_scale_l=None):
    """Decode attention of one layer over a paged KV pool.

    q [R, Hq, D] f32, already scaled by 1/sqrt(D) (the kernel applies no
    scale); k_pages_l/v_pages_l [Hkv, P, ps, D] bf16, or int8 with
    [Hkv, P, ps, 1] f32 scales; lengths int32 [R] (>= 1); tables int32
    [R, MAXP]. Layer li of a pool is `pool[li]`, a view: the kernel reads it
    by pointer, nothing is copied. Returns [R, Hq, Dv] f32. Shapes of the
    gather route (decode_route) take paged_gather on every device; otherwise
    CPU tensors take the plain version, and CUDA tensors launch the kernel
    (D = 128, Hq a multiple of Hkv) or raise."""
    r, hq, d = q.shape
    if decode_route(d, dv=v_pages_l.shape[-1], paged=True) == "gather":
        ROUTE_COUNTS["gather"] += 1
        return paged_gather(q, k_pages_l, v_pages_l, lengths, tables, k_scale_l,
                            v_scale_l)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages_l, v_pages_l, lengths, tables,
                                     k_scale_l, v_scale_l)
    hkv, n_pages, ps, dk = k_pages_l.shape
    quant = k_scale_l is not None
    _check_group("paged_attention", d, hq, hkv, dk)
    page_t = torch.int8 if quant else torch.bfloat16
    maxp = tables.shape[-1]
    named = [("q", q, torch.float32, (r, hq, d)),
             ("k_pages", k_pages_l, page_t, (hkv, n_pages, ps, d)),
             ("v_pages", v_pages_l, page_t, (hkv, n_pages, ps, d)),
             ("lengths", lengths, torch.int32, (r,)),
             ("tables", tables, torch.int32, (r, maxp))]
    if quant:
        named += [("k_scale", k_scale_l, torch.float32, (hkv, n_pages, ps, 1)),
                  ("v_scale", v_scale_l, torch.float32, (hkv, n_pages, ps, 1))]
    elif v_scale_l is not None:
        raise ValueError("v_scale given without k_scale")
    for name, t, dt, shape in named:
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"{dt} {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = min(maxp, max(1, -(-4 * sms // (r * hkv * head_chunks(hq // hkv)))))
    pps = -(-maxp // n_split)                    # pages a split
    n_split = -(-maxp // pps)
    out = torch.empty((r, hq, d), dtype=torch.float32, device=q.device)
    m_part = torch.empty((r, hq, n_split), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((r, hq, n_split, d), dtype=torch.float32,
                           device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    f = _build.fn("paged_attention", "paged_attention", [P] * 11 + [I] * 9 + [P])
    _build.check(f(q.data_ptr(), k_pages_l.data_ptr(), v_pages_l.data_ptr(),
                   ptr(k_scale_l), ptr(v_scale_l), lengths.data_ptr(),
                   tables.data_ptr(), out.data_ptr(), m_part.data_ptr(),
                   l_part.data_ptr(), acc_part.data_ptr(), r, hq, hkv, n_pages,
                   ps, maxp, pps, n_split, int(quant),
                   torch.cuda.current_stream(q.device).cuda_stream),
                 "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

KERNELS = (flash_decode_write_stacked, flash_prefill, paged_attention, flash_decode)
