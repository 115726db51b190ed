"""Sampling chain of the port: penalties, logit bias, top-k, tail-free,
locally-typical, top-p, min-p, temperature or dynamic temperature.

Counterpart of llamafile_tpu/runtime/sampling.py (reference chain order:
bias -> penalties -> top_k -> tfs_z -> typical_p -> top_p -> min_p ->
temperature last, every cutoff on the untempered distribution). Everything
runs on the logits' device.

The random draw is a Gumbel-max, as `jax.random.categorical` is
(argmax(logits + gumbel)). Both samplers take their noise from `_gumbel`,
which draws from an explicit torch.Generator: a seed gives the same tokens
run to run on one device, not the JAX package's tokens (the two generators
differ). A test hands both packages the same noise by replacing `_gumbel`.

`sample` is the single-row chain (the Engine and the batcher's admission
draw); `sample_batched` the continuous batcher's per-row chain inside a
top-64 candidate budget. The penalty window (`PenaltyWindow`) is updated in
place; the JAX package returned a new one from each step instead. Mirostat
is not ported: `sample` raises for it, and the batcher never runs it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    penalty_last_n: int = 64
    logit_bias: Tuple[Tuple[int, float], ...] = ()
    seed: int = 0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0 and self.mirostat == 0

    @property
    def penalized(self) -> bool:
        return self.penalty_last_n != 0 and (
            self.repeat_penalty != 1.0 or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0)


def check_ported(params: SamplingParams) -> None:
    """Raise NotImplementedError for what Engine.generate's decode loop does
    not carry: the penalty window and mirostat's state."""
    for on, name in ((params.penalized, "repetition penalties in Engine.generate "
                      "(the batcher carries them)"),
                     (params.mirostat != 0, "mirostat")):
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def _gumbel(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` from `gen` on `device`."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, repeat: float,
                    presence: float, frequency: float) -> torch.Tensor:
    """counts [B, V]: occurrences of each token in the penalty window."""
    seen = counts > 0
    if repeat != 1.0:
        logits = torch.where(seen, torch.where(logits > 0, logits / repeat,
                                               logits * repeat), logits)
    return logits - counts * frequency - seen.float() * presence


def apply_logit_bias(logits: torch.Tensor, bias) -> torch.Tensor:
    if not bias:
        return logits
    ids = torch.tensor([t for t, _ in bias], dtype=torch.long, device=logits.device)
    vals = torch.tensor([v for _, v in bias], dtype=torch.float32,
                        device=logits.device)
    return logits.index_add(1, ids, vals[None, :].expand(logits.shape[0], -1))


# ---------------------------------------------------------------------------
# Penalty window (reference penalty_last_n, default 64)
# ---------------------------------------------------------------------------

@dataclass
class PenaltyWindow:
    """Sliding-window token counts of the last `last_n` tokens of each row.

    counts [B, V] f32; ring [B, N] int32 (the last N token ids); rlen [B]
    int32 (tokens pushed so far); last_n [B] int32 (<= N; <= 0 never evicts,
    penalty_last_n = -1 is the whole context)."""
    counts: torch.Tensor
    ring: torch.Tensor
    rlen: torch.Tensor
    last_n: torch.Tensor


def penalty_window_init(ids_list: Sequence[int], n_vocab: int, last_n: int,
                        ring_size: Optional[int] = None,
                        device="cuda") -> PenaltyWindow:
    """The window of ONE row from its whole context (host-side).

    ring_size: the ring width of a batched carrier (last_n clamps to it);
    by default the ring is last_n wide."""
    n = max(1, ring_size if ring_size is not None
            else (last_n if last_n > 0 else 1))
    eff = min(last_n, n) if last_n > 0 else (-1 if last_n < 0 else 0)
    counts = np.zeros((1, n_vocab), np.float32)
    ring = np.zeros((1, n), np.int32)
    window = (ids_list if eff < 0
              else ids_list[-min(eff, len(ids_list)):] if eff > 0 else [])
    for t in window:
        counts[0, t] += 1.0
    rlen = len(ids_list)
    for j, t in enumerate(ids_list[-min(n, rlen):] if rlen else []):
        ring[0, (rlen - min(n, rlen) + j) % n] = t
    t = lambda a: torch.from_numpy(a).to(device)
    return PenaltyWindow(t(counts), t(ring), t(np.asarray([rlen], np.int32)),
                         t(np.asarray([eff], np.int32)))


def penalty_window_push(pw: PenaltyWindow, nxt: torch.Tensor) -> PenaltyWindow:
    """Push one token a row (nxt int [B]) IN PLACE, evicting the token that
    leaves each row's last_n window. Returns pw."""
    b = nxt.shape[0]
    n = pw.ring.shape[1]
    rows = torch.arange(b, device=nxt.device)
    evict_on = (pw.last_n > 0) & (pw.rlen >= pw.last_n)
    evict_pos = torch.where(pw.last_n > 0, (pw.rlen - pw.last_n) % n,
                            torch.zeros_like(pw.rlen)).long()
    old = pw.ring[rows, evict_pos].long()
    pw.counts.index_put_((rows, old), -evict_on.float(), accumulate=True)
    pw.ring[rows, (pw.rlen % n).long()] = nxt.to(pw.ring.dtype)
    pw.counts.index_put_((rows, nxt.long()),
                         torch.ones(b, device=nxt.device), accumulate=True)
    pw.rlen += 1
    return pw


# ---------------------------------------------------------------------------
# Chain stages (full vocabulary)
# ---------------------------------------------------------------------------

def _scatter_sorted_mask(keep_sorted: torch.Tensor, order: torch.Tensor):
    """keep mask in sorted order -> keep mask in vocabulary order."""
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _edge_pad2(a: torch.Tensor) -> torch.Tensor:
    """Pad the last axis by two copies of its last value (jnp.pad 'edge')."""
    return torch.cat([a, a[..., -1:].expand(*a.shape[:-1], 2)], dim=-1)


def _tfs_mask(logits: torch.Tensor, z: float) -> torch.Tensor:
    """Tail-free sampling (llama_sample_tail_free): keep the candidates
    before the normalized |second derivative| of the sorted probabilities
    sums past z. Returns masked logits."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sl = torch.gather(logits, -1, order)
    p = torch.softmax(sl, dim=-1)
    live = torch.isfinite(sl)
    n_live = live.sum(-1, keepdim=True)
    fd = p[..., :-1] - p[..., 1:]
    sd = (fd[..., :-1] - fd[..., 1:]).abs()
    i = torch.arange(sd.shape[-1], device=logits.device)[None, :]
    valid = i < (n_live - 2)
    sd = torch.where(valid, sd, torch.zeros_like(sd))
    ssum = sd.sum(-1, keepdim=True)
    n_sd = (n_live - 2).clamp(min=1).float()
    sd = torch.where(ssum > 1e-6, sd / ssum.clamp(min=1e-20),
                     torch.where(valid, 1.0 / n_sd, torch.zeros_like(sd)))
    cum = torch.cumsum(sd, dim=-1)
    ti = torch.arange(p.shape[-1], device=logits.device)[None, :]
    cum_tok = torch.gather(_edge_pad2(cum), -1,
                           torch.minimum(ti, (n_live - 3).clamp(min=0)).expand_as(p))
    keep_sorted = ((ti == 0) | (cum_tok <= z)) & live
    keep = _scatter_sorted_mask(keep_sorted, order)
    return torch.where(keep, logits, torch.full_like(logits, -math.inf))


def _entropy(logp: torch.Tensor) -> torch.Tensor:
    p = torch.exp(logp)
    return -torch.where(p > 0, p * logp, torch.zeros_like(p)).sum(-1, keepdim=True)


def _typical_mask(logits: torch.Tensor, tp: float) -> torch.Tensor:
    """Locally-typical sampling (llama_sample_typical): rank candidates by
    |surprise - entropy|, keep until the cumulative probability crosses tp
    (the crossing candidate is kept)."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    ent = _entropy(logp)
    shifted = torch.where(torch.isfinite(logits), (-logp - ent).abs(),
                          torch.full_like(logits, math.inf))
    order = torch.argsort(shifted, dim=-1, stable=True)
    ps = torch.gather(p, -1, order)
    cum_excl = torch.cumsum(ps, dim=-1) - ps
    ti = torch.arange(p.shape[-1], device=logits.device)[None, :]
    keep_sorted = (((ti == 0) | (cum_excl <= tp))
                   & torch.isfinite(torch.gather(logits, -1, order)))
    keep = _scatter_sorted_mask(keep_sorted, order)
    return torch.where(keep, logits, torch.full_like(logits, -math.inf))


def _dyn_temp(logits: torch.Tensor, temp: float, rng: float, expo: float):
    """llama_sample_entropy: the normalized entropy of the candidates maps
    to a temperature in [max(0, temp-rng), max(0, temp+rng)]; [B, 1]."""
    min_t = max(0.0, temp - rng)
    max_t = max(0.0, temp + rng)
    ent = _entropy(torch.log_softmax(logits, dim=-1))
    n_live = torch.isfinite(logits).sum(-1, keepdim=True)
    max_ent = torch.log(n_live.float().clamp(min=1.0))
    norm = torch.where(max_ent > 0, ent / max_ent, torch.zeros_like(ent))
    return min_t + (max_t - min_t) * torch.pow(norm, expo)


def sample(logits: torch.Tensor, gen: Optional[torch.Generator],
           params: SamplingParams, counts: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """logits [B, V] -> token ids int32 [B] on the logits' device; counts
    [B, V] (a PenaltyWindow's) applies the repetition penalties."""
    if params.mirostat:
        raise NotImplementedError("mirostat is not ported yet")
    logits = apply_logit_bias(logits.float(), params.logit_bias)
    if counts is not None and params.penalized:
        logits = apply_penalties(logits, counts, params.repeat_penalty,
                                 params.presence_penalty, params.frequency_penalty)
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    neg = torch.full_like(logits, -math.inf)
    v = logits.shape[-1]
    if params.top_k and params.top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - params.top_k:
                                                v - params.top_k + 1]
        logits = torch.where(logits < kth, neg, logits)
    if params.tfs_z < 1.0:
        logits = _tfs_mask(logits, params.tfs_z)
    if params.typical_p < 1.0:
        logits = _typical_mask(logits, params.typical_p)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens until the cumulative prob exceeds top_p (always the best)
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=v - 1))
        logits = torch.where(logits < cutoff, neg, logits)
    if params.min_p > 0.0:
        max_logit = logits.amax(dim=-1, keepdim=True)
        logits = torch.where(logits < max_logit + math.log(params.min_p), neg,
                             logits)
    if params.dynatemp_range > 0.0:
        t = _dyn_temp(logits, params.temperature, params.dynatemp_range,
                      params.dynatemp_exponent)
        logits = logits / t.clamp(min=1e-4)
    else:
        logits = logits / max(params.temperature, 1e-4)
    noise = _gumbel(logits.shape, gen, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Batched per-row chain (continuous batcher)
# ---------------------------------------------------------------------------

K_BUDGET = 64


@dataclass
class RowParams:
    """Per-row sampling knobs of the fused batcher step: [R] f32 or int32
    tensors, and an optional [R, V] logit-offset table."""
    temps: torch.Tensor
    top_ps: torch.Tensor
    min_ps: torch.Tensor
    top_ks: torch.Tensor
    rep_pens: torch.Tensor
    pres_pens: torch.Tensor
    freq_pens: torch.Tensor
    tfs_zs: torch.Tensor
    typ_ps: torch.Tensor
    dt_ranges: torch.Tensor
    dt_exps: torch.Tensor
    bias: Optional[torch.Tensor] = None


def row_params_from_sp(sps: Sequence[SamplingParams], n_vocab: int,
                       device="cuda") -> RowParams:
    """RowParams from per-row SamplingParams (host-side). Rows with
    penalty_last_n == 0 get neutral penalties (the reference: last_n 0
    disables them whatever the knobs say)."""
    r = len(sps)
    f = lambda g: torch.tensor([g(sp) for sp in sps], dtype=torch.float32,
                               device=device)
    bias = None
    if any(sp.logit_bias for sp in sps):
        b = np.zeros((r, n_vocab), np.float32)
        for i, sp in enumerate(sps):
            for t, x in sp.logit_bias:
                if 0 <= t < n_vocab:
                    b[i, t] += x
        bias = torch.from_numpy(b).to(device)
    on = lambda sp: sp.penalty_last_n != 0
    return RowParams(
        temps=f(lambda s: s.temperature),
        top_ps=f(lambda s: s.top_p),
        min_ps=f(lambda s: s.min_p),
        top_ks=torch.tensor([sp.top_k for sp in sps], dtype=torch.int32,
                            device=device),
        rep_pens=f(lambda s: s.repeat_penalty if on(s) else 1.0),
        pres_pens=f(lambda s: s.presence_penalty if on(s) else 0.0),
        freq_pens=f(lambda s: s.frequency_penalty if on(s) else 0.0),
        tfs_zs=f(lambda s: s.tfs_z),
        typ_ps=f(lambda s: s.typical_p),
        dt_ranges=f(lambda s: s.dynatemp_range),
        dt_exps=f(lambda s: s.dynatemp_exponent),
        bias=bias,
    )


def _row_noise(gens: Sequence[Optional[torch.Generator]], k: int, device):
    """[R, k] Gumbel noise, one draw of k from each row's own generator (a
    row without one gets zeros: it samples greedily), so a row's stream
    does not depend on the rows beside it."""
    return torch.stack([_gumbel((k,), g, device) if g is not None
                        else torch.zeros(k, device=device) for g in gens])


def sample_batched(logits: torch.Tensor,
                   gens: Sequence[Optional[torch.Generator]], rp: RowParams,
                   counts: Optional[torch.Tensor] = None,
                   k_budget: int = K_BUDGET) -> torch.Tensor:
    """Per-row sampling for the continuous batcher, the reference chain.

    logits [R, V]; gens: one torch.Generator a row (each request's own
    stream, from its seed); counts [R, V] penalty-window counts. Rows with
    temperature <= 0 decode greedily over the penalized logits. The others
    run top_k, tfs_z, typical_p, top_p and min_p on the untempered
    distribution inside the top-k_budget candidates, then temperature or
    dynamic temperature last. Returns int32 [R]."""
    r, v = logits.shape
    dev = logits.device
    logits = logits.float()
    if rp.bias is not None:
        logits = logits + rp.bias
    if counts is not None:
        seen = counts > 0
        rpen = rp.rep_pens[:, None]
        logits = torch.where(seen, torch.where(logits > 0, logits / rpen,
                                               logits * rpen), logits)
        logits = (logits - counts * rp.freq_pens[:, None]
                  - seen.float() * rp.pres_pens[:, None])
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = torch.topk(logits, k_budget, dim=-1)     # [R, K] descending
    neg = torch.full_like(vals, -math.inf)
    ti = torch.arange(k_budget, device=dev)[None, :]
    eff_k = torch.where(rp.top_ks <= 0, torch.full_like(rp.top_ks, k_budget),
                        rp.top_ks.clamp(max=k_budget))
    vals = torch.where(ti < eff_k[:, None], vals, neg)
    # tail-free within the budget (already sorted descending)
    p = torch.softmax(vals, dim=-1)
    n_live = torch.isfinite(vals).sum(-1, keepdim=True)
    fd = p[:, :-1] - p[:, 1:]
    sd = (fd[:, :-1] - fd[:, 1:]).abs()
    valid = ti[:, :k_budget - 2] < (n_live - 2)
    sd = torch.where(valid, sd, torch.zeros_like(sd))
    ssum = sd.sum(-1, keepdim=True)
    n_sd = (n_live - 2).clamp(min=1).float()
    sd = torch.where(ssum > 1e-6, sd / ssum.clamp(min=1e-20),
                     torch.where(valid, 1.0 / n_sd, torch.zeros_like(sd)))
    cum_tok = torch.gather(_edge_pad2(torch.cumsum(sd, dim=-1)), -1,
                           torch.minimum(ti, (n_live - 3).clamp(min=0)).expand(r, -1))
    tz = rp.tfs_zs[:, None]
    vals = torch.where((ti == 0) | (cum_tok <= tz) | (tz >= 1.0), vals, neg)
    # locally typical within the budget
    logp = torch.log_softmax(vals, dim=-1)
    pt = torch.exp(logp)
    ent = _entropy(logp)
    shifted = torch.where(torch.isfinite(vals), (-logp - ent).abs(),
                          torch.full_like(vals, math.inf))
    order = torch.argsort(shifted, dim=-1, stable=True)
    ps = torch.gather(pt, -1, order)
    cum_excl = torch.cumsum(ps, dim=-1) - ps
    tpp = rp.typ_ps[:, None]
    keep_sorted = (ti == 0) | (cum_excl <= tpp) | (tpp >= 1.0)
    vals = torch.where(_scatter_sorted_mask(keep_sorted, order), vals, neg)
    # top_p / min_p on the untempered candidate probabilities (typical's
    # holes have p = 0 and leave the running sum monotonic)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < rp.top_ps[:, None]
    keep_m = probs >= probs.amax(-1, keepdim=True) * rp.min_ps[:, None]
    masked = torch.where(keep_p & keep_m, vals, neg)
    # temperature last (dynamic per row when its range > 0)
    safe_t = rp.temps.clamp(min=1e-4)
    mlogp = torch.log_softmax(masked, dim=-1)
    ment = _entropy(mlogp)[:, 0]
    mn = torch.isfinite(masked).sum(-1).clamp(min=1)
    ment_max = torch.log(mn.float())
    norm = torch.where(ment_max > 0, ment / ment_max, torch.zeros_like(ment))
    min_t = (rp.temps - rp.dt_ranges).clamp(min=0.0)
    max_t = (rp.temps + rp.dt_ranges).clamp(min=0.0)
    dyn_t = min_t + (max_t - min_t) * torch.pow(norm, rp.dt_exps)
    t_eff = torch.where(rp.dt_ranges > 0.0, dyn_t.clamp(min=1e-4), safe_t)
    noise = _row_noise(gens, k_budget, dev)
    picked = torch.argmax(masked / t_eff[:, None] + noise, dim=-1)
    sampled = torch.gather(idx, 1, picked[:, None])[:, 0].to(torch.int32)
    return torch.where(rp.temps <= 0.0, greedy_tok, sampled)
