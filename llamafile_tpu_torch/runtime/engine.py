"""Inference engine of the port: prefill, chunked decode, generation loop.

Counterpart of llamafile_tpu/runtime/engine.py for single-sequence
generation. The JAX package compiled a prefill and an n-step decode scan;
here `prefill` is one forward over the bucketed prompt and the decode chunk
is a loop of `decode_chunk` steps whose tokens stay on the device and are
read back once per chunk.

A prompt runs as one prefill over its bucket (PREFILL_BUCKETS, then
multiples of 4096), up to max_seq_len tokens: buckets of 16 and 32 take the
q4b txn kernel, longer ones the dequant GEMM and, from 128 tokens, the
flash_prefill kernel.

LLAMAFILE_TPU_I8P=1 (read when the Engine is built, off by default, as in
the reference) attaches the int8 prefill companions before the layers are
stacked (models.llama.int8_prefill_params): prompts and admission slices of
over 32 tokens then run the int8 prefill kernel; decode never reads them.

The KV cache follows kv_dtype: bf16, or int8 codes with per-row scales
(runtime/kvcache.py). The continuous batcher (server/batcher.py) drives the
engine through its serving hooks: `new_row_cache` and `row_prefill` for
admission (bf16 row caches, as the reference's), and the paged pool it
keeps itself (bf16 or int8 pages by kv_dtype).
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..models.llama import (LlamaConfig, LlamaParams, forward, init_cache,
                            int8_prefill_params, stack_layers)
from .sampling import SamplingParams, check_ported, sample
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
        # copy); layers of differing formats stay unrolled
        self.params = stack_layers(params)
        self.tokenizer = tokenizer
        self.max_seq_len = min(max_seq_len, cfg.max_context)
        self.batch_size = batch_size
        if isinstance(kv_dtype, str):
            kv_dtype = {"bf16": torch.bfloat16, "int8": torch.int8,
                        "i8": torch.int8}[kv_dtype]
        if kv_dtype not in (torch.bfloat16, torch.int8):
            raise NotImplementedError(f"kv_dtype {kv_dtype}: bf16 or int8")
        self.kv_dtype = kv_dtype
        self.decode_chunk = 8        # tokens per device-resident decode chunk

    def new_cache(self):
        return init_cache(self.cfg, self.batch_size, self.max_seq_len,
                          self.kv_dtype, device=self.device)

    # -- serving hooks (driven by server.batcher.Batcher) -------------------

    supports_paged = True          # the batcher keeps a paged KV pool
    recurrent = False

    def init_row_cache(self, rows: int, dtype=None):
        raise NotImplementedError("the dense row-batched cache of the "
                                  "batcher is not ported: it runs paged")

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

    def prefill(self, cache, token_ids: List[int], pos0: int = 0):
        """Feed prompt tokens; returns (last_logits f32 [V], cache)."""
        n = len(token_ids)
        b = bucket_len(n)
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
               n_steps: int, attn_len: Optional[int] = None) -> torch.Tensor:
        """n_steps decode steps on the device; returns tokens [B, n_steps].

        tok [B] and pos [B] are the chunk's state and are advanced IN PLACE
        (the JAX scan carried them, with the cache donated); the cache is
        updated in place by the decode kernel."""
        toks = torch.empty((tok.shape[0], n_steps), dtype=torch.int32,
                           device=tok.device)
        for i in range(n_steps):
            logits, _ = forward(self.params, self.cfg, tok[:, None], pos, cache,
                                attn_len=attn_len)
            nxt = sample(logits[:, -1, :], gen, sp)
            toks[:, i] = nxt
            tok.copy_(nxt)
            pos += 1
        return toks

    def generate(self, prompt: str, max_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 stop_on_eog: bool = True,
                 prompt_ids: Optional[List[int]] = None
                 ) -> Iterator[Tuple[int, str]]:
        """Stream (token_id, text_piece) pairs."""
        sp = sampling or SamplingParams()
        check_ported(sp)
        ids = prompt_ids if prompt_ids is not None else self.tokenizer.encode(prompt)
        if len(ids) >= self.max_seq_len:
            ids = ids[-max(1, self.max_seq_len - max_tokens - 1):]
        max_tokens = min(max_tokens, self.max_seq_len - len(ids))
        cache = self.new_cache()
        last_logits, cache = self.prefill(cache, ids)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sp.seed)
        tok = sample(last_logits[None, :], gen, sp)
        pos = torch.full((self.batch_size,), len(ids), dtype=torch.int32,
                         device=self.device)
        pos_host = len(ids)
        first = int(tok[0])
        if stop_on_eog and self.tokenizer.is_eog(first):
            return
        yield first, self.tokenizer.decode_token(first).decode("utf-8", errors="replace")
        emitted = 1
        while emitted < max_tokens and pos_host + 1 < self.max_seq_len:
            chunk = min(self.decode_chunk, max_tokens - emitted,
                        self.max_seq_len - 1 - pos_host)
            alen = attn_bucket(pos_host + chunk + 1, self.max_seq_len)
            toks = self.decode(tok, pos, cache, gen, sp, chunk, attn_len=alen)
            pos_host += chunk
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


def load_engine(path: str, device="cuda", **kw) -> Engine:
    from ..models.loader import load_llama
    cfg, params, tok, _reader = load_llama(path, device=device)
    return Engine(cfg, params, tok, device=device, **kw)
