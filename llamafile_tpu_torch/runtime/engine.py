"""Inference engine of the port: prefill, chunked decode, generation loop.

Counterpart of llamafile_tpu/runtime/engine.py for single-sequence
generation. The JAX package compiled a prefill and an n-step decode scan;
here `prefill` is one forward over the bucketed prompt and the decode chunk
is a loop of `decode_chunk` steps whose tokens stay on the device and are
read back once per chunk.

A prompt runs as one prefill over its bucket (PREFILL_BUCKETS, then
multiples of 4096), up to max_seq_len tokens: buckets of 16 and 32 take the
q4b txn kernel, longer ones the dequant GEMM and, from 128 tokens, the
flash_prefill kernel. One token that continues a cache (a prompt_cache
resume, a reused prefix at the batcher's admission) is not padded: it runs
as a decode step, on the M = 1 kernels and the fused decode attention
(`slice_len`).

LLAMAFILE_TPU_I8P=1 (read when the Engine is built, off by default, as in
the reference) attaches the int8 prefill companions before the layers are
stacked (models.llama.int8_prefill_params): prompts and admission slices of
over 32 tokens then run the int8 prefill kernel; decode never reads them.

The KV cache follows kv_dtype: bf16, f16, f32, or int8 codes with per-row
scales (runtime/kvcache.py; the reference's map of "bf16", "f16", "f32",
"int8" and "i8").

LLAMAFILE_TPU_STACK=0 (read when the Engine is built, as in the
reference) keeps the layers unrolled: prefill then runs the unstacked
products (qmm_planes from bucket 64) and decode the per-layer M = 1
products and flash_decode_write on each layer's view.

The continuous batcher (server/batcher.py) drives the
engine through its serving hooks: `new_row_cache` and `row_prefill` for
admission, and either the paged pool it keeps itself (pages of kv_dtype:
bf16, f16, f32 or int8) or, in its dense row mode, `init_row_cache` (the row-batched
cache [L, R, S, ...]) and `fused_decode` (a chunk of steps over all rows,
each at its own position).

The decode loop carries what the reference's scan carried: the penalty
window (repeat/presence/frequency penalties over the last penalty_last_n
tokens) and mirostat's mu, both on the device; sampling launches no
kernel. `generate(prompt_cache=path)` is the reference's session file
(runtime/state.py): the common prefix with the saved history is loaded
instead of prefilled, and the new prompt's state is saved after the
prefill. `ChatSession` keeps one cache across the turns of a conversation
and prefills only what a turn adds. Left out: the batch sizes above 1,
self-extend (grp_attn_n) and the multimodal prefill.
"""
from __future__ import annotations

import os
import zipfile
from typing import Iterator, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.llama import (LlamaConfig, LlamaParams, forward, init_cache,
                            int8_prefill_params, stack_layers)
from .sampling import (PenaltyWindow, RowParams, SamplingParams,
                       mirostat_init, penalty_window_init, penalty_window_push,
                       sample_batched, sample_stateful)
from .tokenizer import Tokenizer

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# every bucket is a multiple of 256 so a decode KV block divides it
ATTN_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192,
                12288, 16384, 24576, 32768)


def attn_bucket(needed: int, max_len: int) -> int:
    """Smallest attention-window bucket covering `needed` positions."""
    for b in ATTN_BUCKETS:
        if b >= needed:
            return min(b, max_len)
    return max_len


def bucket_len(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


def slice_len(n: int, pos0: int) -> int:
    """Length a prefill slice of n tokens at pos0 runs at: one token past
    pos0 > 0 as a decode step (T = 1), the rest padded to its bucket."""
    return 1 if n == 1 and pos0 > 0 else bucket_len(n)


class Engine:
    """Single-model, single-sequence inference engine on one device."""

    def __init__(self, cfg: LlamaConfig, params: LlamaParams,
                 tokenizer: Tokenizer, max_seq_len: int = 2048,
                 batch_size: int = 1, kv_dtype=torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        if params.tok_embd.device.type != self.device.type:
            raise ValueError(f"params live on {params.tok_embd.device}, the "
                             f"engine was asked to run on {self.device}")
        if batch_size != 1:
            raise NotImplementedError("batched decode belongs to the serving "
                                      "slice; the engine runs batch_size=1")
        self.cfg = cfg
        if os.environ.get("LLAMAFILE_TPU_I8P", "0") == "1":
            # opt-in int8 prefill: companions on the unstacked layers
            params = int8_prefill_params(params)
        # the layer loop indexes stacked weights by layer id (no slice
        # copy); layers of differing formats stay unrolled, and so do all
        # under LLAMAFILE_TPU_STACK=0
        if os.environ.get("LLAMAFILE_TPU_STACK", "1") != "0":
            params = stack_layers(params)
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq_len = min(max_seq_len, cfg.max_context)
        self.batch_size = batch_size
        if isinstance(kv_dtype, str):
            kv_dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
                        "f32": torch.float32, "i8": torch.int8,
                        "int8": torch.int8}[kv_dtype]
        if kv_dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
            raise ValueError(f"kv_dtype {kv_dtype}: bf16, f16, f32 or int8")
        self.kv_dtype = kv_dtype
        self.decode_chunk = 8        # tokens per device-resident decode chunk
        self.last_prompt_reuse = 0   # prompt_cache tokens reused by generate

    def new_cache(self):
        return init_cache(self.cfg, self.batch_size, self.max_seq_len,
                          self.kv_dtype, device=self.device)

    # -- serving hooks (driven by server.batcher.Batcher) -------------------

    supports_paged = True          # the batcher keeps a paged KV pool
    recurrent = False

    def init_row_cache(self, rows: int, dtype=None):
        """Row-batched KV cache [L, R, S, ...] of the batcher's dense mode."""
        return init_cache(self.cfg, rows, self.max_seq_len,
                          dtype or self.kv_dtype, device=self.device)

    def new_row_cache(self, dtype=None):
        """Single-row admission cache [L, 1, S, Hkv*D]."""
        return init_cache(self.cfg, 1, self.max_seq_len,
                          dtype or self.kv_dtype, device=self.device)

    def row_prefill(self, tokens, pos0, row_cache, fresh=False,
                    attn_len=None, last_idx=None):
        """One admission slice into the row cache (updated in place);
        returns (logits [1, 1 or T, V], row_cache)."""
        return forward(self.params, self.cfg, tokens, pos0, row_cache,
                       fresh_prefill=fresh, attn_len=attn_len,
                       last_idx=last_idx)

    @torch.no_grad()
    def fused_decode(self, tok, pos, cache, pw: PenaltyWindow,
                     gens: List[Optional[torch.Generator]], rp: RowParams,
                     n_steps: int, attn_len: Optional[int] = None
                     ) -> torch.Tensor:
        """n_steps decode steps over every row of a row-batched cache: each
        step forward, sample_batched with each row's knobs and generator,
        penalty_window_push. tok/pos int32 [R], each row at its own
        position; cache and pw are updated in place. A position never
        passes S - 1, the trash slot where parked rows write (the
        reference's clamped cache update). Returns tokens int32 [n_steps,
        R] on the device."""
        last = cache.max_len - 1
        toks = torch.empty((n_steps, tok.shape[0]), dtype=torch.int32,
                           device=tok.device)
        for i in range(n_steps):
            logits, _ = forward(self.params, self.cfg, tok[:, None], pos, cache,
                                attn_len=attn_len)
            nxt = sample_batched(logits[:, -1, :], gens, rp, pw.counts)
            penalty_window_push(pw, nxt)
            toks[i] = nxt
            tok, pos = nxt, torch.clamp(pos + 1, max=last)
        return toks

    def prefill(self, cache, token_ids: List[int], pos0: int = 0):
        """Feed prompt tokens; returns (last_logits f32 [V], cache)."""
        n = len(token_ids)
        b = slice_len(n, pos0)
        toks = torch.zeros((self.batch_size, b), dtype=torch.int32)
        toks[0, :n] = torch.tensor(token_ids, dtype=torch.int32)
        pos = torch.full((self.batch_size,), pos0, dtype=torch.int32,
                         device=self.device)
        last = torch.full((self.batch_size,), n - 1, dtype=torch.int32,
                          device=self.device)
        logits, cache = forward(self.params, self.cfg, toks.to(self.device),
                                pos, cache, fresh_prefill=(pos0 == 0),
                                last_idx=last)
        return logits[0, 0], cache

    def decode(self, tok: torch.Tensor, pos: torch.Tensor, cache,
               gen: Optional[torch.Generator], sp: SamplingParams,
               n_steps: int, attn_len: Optional[int] = None,
               pw: Optional[PenaltyWindow] = None,
               mu: Optional[torch.Tensor] = None):
        """n_steps decode steps on the device; returns (tokens [B, n_steps],
        mu).

        tok [B] and pos [B] are the chunk's state and are advanced IN PLACE,
        as is the penalty window pw (the JAX scan carried them, with the
        cache donated); mu, mirostat's state, is returned. The cache is
        updated in place by the decode kernel."""
        toks = torch.empty((tok.shape[0], n_steps), dtype=torch.int32,
                           device=tok.device)
        for i in range(n_steps):
            logits, _ = forward(self.params, self.cfg, tok[:, None], pos, cache,
                                attn_len=attn_len)
            nxt, mu = sample_stateful(logits[:, -1, :], gen, sp,
                                      pw.counts if pw is not None else None, mu)
            if pw is not None:
                penalty_window_push(pw, nxt)
            toks[:, i] = nxt
            tok.copy_(nxt)
            pos += 1
        return toks, mu

    def _load_prompt_cache(self, path: str, ids: List[int], cache) -> int:
        """Copy the saved state's common prefix with ids into cache; returns
        the tokens kept (at least one short of ids), 0 when the file is
        missing, corrupt or of another layout (the prompt is recomputed)."""
        from .state import load_state
        try:
            c0, hist = load_state(path, max_len=self.max_seq_len)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return 0                       # a corrupt or foreign file: recompute
        keep = 0
        n = min(len(hist), len(ids))
        while keep < n and hist[keep] == ids[keep]:
            keep += 1
        keep = min(keep, len(ids) - 1)     # one token at least is prefilled
        pairs = list(zip((c0.k, c0.v, c0.k_scale, c0.v_scale),
                         (cache.k, cache.v, cache.k_scale, cache.v_scale)))
        if keep <= 0 or any((src is None) != (dst is None)
                            or (src is not None and src.shape != dst.shape)
                            for src, dst in pairs):
            return 0
        for src, dst in pairs:
            if src is not None:
                dst.copy_(src.to(dst.dtype))
        return keep

    def generate(self, prompt: str, max_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 stop_on_eog: bool = True,
                 prompt_ids: Optional[List[int]] = None,
                 prompt_cache: Optional[str] = None
                 ) -> Iterator[Tuple[int, str]]:
        """Stream (token_id, text_piece) pairs.

        prompt_cache: a session file (the reference's --prompt-cache): the
        saved KV of the common prompt prefix is reused, and the new
        prompt's state is saved after the prefill. `last_prompt_reuse`
        holds the tokens reused by the last call."""
        sp = sampling or SamplingParams()
        ids = prompt_ids if prompt_ids is not None else self.tokenizer.encode(prompt)
        if len(ids) >= self.max_seq_len:
            ids = ids[-max(1, self.max_seq_len - max_tokens - 1):]
        max_tokens = min(max_tokens, self.max_seq_len - len(ids))
        cache = self.new_cache()
        keep = 0
        if prompt_cache and os.path.exists(prompt_cache) and self.batch_size == 1:
            keep = self._load_prompt_cache(prompt_cache, ids, cache)
        self.last_prompt_reuse = keep
        last_logits, cache = self.prefill(cache, ids[keep:], pos0=keep)
        if prompt_cache and self.batch_size == 1 and keep < len(ids):
            from .state import save_state
            save_state(prompt_cache, cache, ids)
        yield from self._stream(ids, cache, last_logits, sp, max_tokens,
                                stop_on_eog)

    def _stream(self, ids: List[int], cache, last_logits, sp: SamplingParams,
                max_tokens: int, stop_on_eog: bool, on_chunk=None
                ) -> Iterator[Tuple[int, str]]:
        """Sample the first token from last_logits, then decode in chunks
        after the prompt ids (already in cache), carrying the penalty window
        and mirostat's mu. on_chunk(pos) is called after each chunk with the
        positions written to the cache."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sp.seed)
        pw = (penalty_window_init(ids, self.cfg.n_vocab, sp.penalty_last_n,
                                  device=self.device) if sp.penalized else None)
        mu = (mirostat_init(sp, self.batch_size, device=self.device)
              if sp.mirostat else None)
        tok, mu = sample_stateful(last_logits[None, :], gen, sp,
                                  pw.counts if pw is not None else None, mu)
        pos = torch.full((self.batch_size,), len(ids), dtype=torch.int32,
                         device=self.device)
        pos_host = len(ids)
        first = int(tok[0])
        if stop_on_eog and self.tokenizer.is_eog(first):
            return
        yield first, self.tokenizer.decode_token(first).decode("utf-8", errors="replace")
        if pw is not None:
            penalty_window_push(pw, tok)
        emitted = 1
        while emitted < max_tokens and pos_host + 1 < self.max_seq_len:
            chunk = min(self.decode_chunk, max_tokens - emitted,
                        self.max_seq_len - 1 - pos_host)
            alen = attn_bucket(pos_host + chunk + 1, self.max_seq_len)
            toks, mu = self.decode(tok, pos, cache, gen, sp, chunk, attn_len=alen,
                                   pw=pw, mu=mu)
            pos_host += chunk
            if on_chunk is not None:
                on_chunk(pos_host)
            for tid in toks[0].tolist():
                if stop_on_eog and self.tokenizer.is_eog(tid):
                    return
                yield tid, self.tokenizer.decode_token(tid).decode(
                    "utf-8", errors="replace")
                emitted += 1
                if emitted >= max_tokens:
                    return

    def complete(self, prompt: str, max_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None, **kw) -> str:
        return "".join(piece for _, piece in
                       self.generate(prompt, max_tokens, sampling, **kw))


class ChatSession:
    """A conversation on one engine: the KV cache is kept between turns and
    only the prompt beyond the common prefix with the previous turn is
    prefilled (the reference's chatbot keeps its context across turns).
    Counterpart of llamafile_tpu/runtime/engine.py's ChatSession."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.cache = engine.new_cache()
        self.ids: List[int] = []
        self.cached_len = 0        # positions written to the cache
        self.reused_last = 0       # prefix tokens reused by the last turn

    def generate(self, prompt_ids: List[int], max_tokens: int = 512,
                 sampling: Optional[SamplingParams] = None,
                 stop_on_eog: bool = True) -> Iterator[Tuple[int, str]]:
        """Stream (token_id, text_piece) pairs of one turn; prompt_ids is
        the whole templated conversation so far."""
        from ..server.slots import common_prefix_len
        eng = self.engine
        sp = sampling or SamplingParams()
        ids = list(prompt_ids)
        if len(ids) >= eng.max_seq_len:
            ids = ids[-max(1, eng.max_seq_len - max_tokens - 1):]
        max_tokens = min(max_tokens, eng.max_seq_len - len(ids))
        # a turn's last sampled token is yielded, but its K/V is written
        # only when a later step consumes it: reuse stops at cached_len
        keep = min(common_prefix_len(self.ids, ids), self.cached_len)
        if keep == len(ids):
            keep = len(ids) - 1
        if keep == 0:
            self.cache = eng.new_cache()
        self.reused_last = keep
        last_logits, self.cache = eng.prefill(self.cache, ids[keep:], pos0=keep)
        self.cached_len = len(ids)
        self.ids = list(ids)

        def written(pos: int):
            self.cached_len = pos
        for tid, piece in eng._stream(ids, self.cache, last_logits, sp,
                                      max_tokens, stop_on_eog, written):
            self.ids.append(tid)
            yield tid, piece


def load_engine(path: str, device="cuda", **kw) -> Engine:
    from ..models.loader import load_llama
    cfg, params, tok, _reader = load_llama(path, device=device)
    return Engine(cfg, params, tok, device=device, **kw)
