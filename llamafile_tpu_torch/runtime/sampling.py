"""Sampling chain of the port: logit bias, top-k, top-p, min-p, temperature.

Counterpart of llamafile_tpu/runtime/sampling.py for what the defaults use
(reference chain order: bias -> top_k -> top_p -> min_p -> temperature last,
cutoffs on the untempered distribution). It runs on the logits' device; the
random draw is a Gumbel-max over noise from an explicit torch.Generator, so a
seed gives the same tokens run to run on one device (not the JAX package's
tokens: the two generators differ).

Repetition penalties, mirostat, tail-free, locally-typical and dynamic
temperature sampling are a later slice and raise NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

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
    """Raise NotImplementedError for the samplers of a later slice."""
    for on, name in ((params.penalized, "repetition penalties"),
                     (params.mirostat != 0, "mirostat"),
                     (params.tfs_z < 1.0, "tail-free sampling"),
                     (params.typical_p < 1.0, "locally-typical sampling"),
                     (params.dynatemp_range > 0.0, "dynamic temperature")):
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def apply_logit_bias(logits: torch.Tensor, bias) -> torch.Tensor:
    if not bias:
        return logits
    ids = torch.tensor([t for t, _ in bias], dtype=torch.long, device=logits.device)
    vals = torch.tensor([v for _, v in bias], dtype=torch.float32,
                        device=logits.device)
    return logits.index_add(1, ids, vals[None, :].expand(logits.shape[0], -1))


def sample(logits: torch.Tensor, gen: Optional[torch.Generator],
           params: SamplingParams) -> torch.Tensor:
    """logits [B, V] f32 -> token ids int32 [B] on the logits' device."""
    check_ported(params)
    logits = apply_logit_bias(logits.float(), params.logit_bias)
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    neg = torch.full_like(logits, -math.inf)
    v = logits.shape[-1]
    if params.top_k and params.top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - params.top_k:
                                                v - params.top_k + 1]
        logits = torch.where(logits < kth, neg, logits)
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
    logits = logits / max(params.temperature, 1e-4)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_stateful(logits: torch.Tensor, gen: Optional[torch.Generator],
                    params: SamplingParams, counts=None, mu=None):
    """The chain with the reference's stateful signature: (tokens, mu)."""
    if counts is not None:
        raise NotImplementedError("penalty windows are not ported yet")
    return sample(logits, gen, params), mu
