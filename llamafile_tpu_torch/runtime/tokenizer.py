"""Tokenizers reconstructed from GGUF metadata: SPM (llama) and byte-level BPE (gpt2).

The port's own copy of llamafile_tpu/runtime/tokenizer.py (pure Python and
numpy). The two algorithms are re-implemented from the format spec so a
GGUF's embedded vocab works without external tokenizer files.

SPM: greedy highest-score bigram merging over UTF-8 symbols with byte fallback
(<0xXX> tokens). BPE: GPT-2 byte-to-unicode mapping + merge-rank BPE with the
GPT-2 pre-tokenization regex.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode printable mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}

# GPT-2 pretokenizer (re module approximation: \p{L} -> [^\W\d_], \p{N} -> \d)
_GPT2_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)

SPM_SPACE = "▁"  # ▁

TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6


class Tokenizer:
    """Vocabulary + encode/decode for SPM and BPE models from GGUF metadata."""

    def __init__(self, metadata: Dict):
        self.model = metadata.get("tokenizer.ggml.model", "llama")
        self.tokens: List[str] = list(metadata.get("tokenizer.ggml.tokens", []))
        scores = metadata.get("tokenizer.ggml.scores")
        self.scores = (np.asarray(scores, np.float32) if scores is not None
                       else np.zeros(len(self.tokens), np.float32))
        ttypes = metadata.get("tokenizer.ggml.token_type")
        self.token_types = (np.asarray(ttypes, np.int32) if ttypes is not None
                            else np.full(len(self.tokens), TOKEN_TYPE_NORMAL, np.int32))
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.bos_id = int(metadata.get("tokenizer.ggml.bos_token_id", 1))
        self.eos_id = int(metadata.get("tokenizer.ggml.eos_token_id", 2))
        self.unk_id = int(metadata.get("tokenizer.ggml.unknown_token_id", 0))
        self.pad_id = int(metadata.get("tokenizer.ggml.padding_token_id", -1))
        self.add_bos = bool(metadata.get("tokenizer.ggml.add_bos_token",
                                         self.model == "llama"))
        self.add_eos = bool(metadata.get("tokenizer.ggml.add_eos_token", False))
        self.add_space_prefix = bool(metadata.get("tokenizer.ggml.add_space_prefix",
                                                  self.model == "llama"))
        self.chat_template: Optional[str] = metadata.get("tokenizer.chat_template")
        merges = metadata.get("tokenizer.ggml.merges")
        self.merge_ranks: Dict[tuple, int] = {}
        if merges:
            for rank, m in enumerate(merges):
                a, _, b = m.partition(" ")
                self.merge_ranks[(a, b)] = rank
        self._byte_tokens: Dict[int, int] = {}
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    self._byte_tokens[int(t[3:5], 16)] = i
                except ValueError:
                    pass
        # EOG set: eos plus common end-of-turn tokens (llama.cpp llama_token_is_eog)
        self.eog_ids = {self.eos_id}
        for name in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
                     "<|endoftext|>", "</s>", "<|eom_id|>"):
            if name in self.vocab:
                self.eog_ids.add(self.vocab[name])

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str, add_bos: Optional[bool] = None,
               special: bool = True) -> List[int]:
        ids: List[int] = []
        if special:
            segments = self._split_specials(text)
        else:
            segments = [(text, None)]
        for seg, tok_id in segments:
            if tok_id is not None:
                ids.append(tok_id)
            elif seg:
                if self.model == "gpt2":
                    ids.extend(self._encode_bpe(seg))
                else:
                    ids.extend(self._encode_spm(seg))
        if add_bos if add_bos is not None else self.add_bos:
            if not ids or ids[0] != self.bos_id:
                ids.insert(0, self.bos_id)
        if self.add_eos:
            ids.append(self.eos_id)
        return ids

    def _split_specials(self, text: str):
        """Split out control/user-defined token literals so they map to their ids."""
        specials = [t for i, t in enumerate(self.tokens)
                    if self.token_types[i] in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
                    and t]
        if not specials:
            return [(text, None)]
        pattern = "|".join(re.escape(s) for s in sorted(specials, key=len, reverse=True))
        out = []
        pos = 0
        for m in re.finditer(pattern, text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append(("", self.vocab[m.group(0)]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    def _encode_spm(self, text: str) -> List[int]:
        if self.add_space_prefix and text and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", SPM_SPACE)
        symbols = list(text)
        if not symbols:
            return []
        # greedy best-score bigram merge (llm_tokenizer_spm semantics)
        while True:
            best = None
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                tid = self.vocab.get(cand)
                if tid is not None and self.token_types[tid] == TOKEN_TYPE_NORMAL:
                    score = self.scores[tid]
                    if best is None or score > best[0]:
                        best = (score, i, cand)
            if best is None:
                break
            _, i, cand = best
            symbols[i:i + 2] = [cand]
        ids = []
        for sym in symbols:
            tid = self.vocab.get(sym)
            if tid is not None:
                ids.append(tid)
            else:
                for byte in sym.encode("utf-8"):
                    ids.append(self._byte_tokens.get(byte, self.unk_id))
        return ids

    def _encode_bpe(self, text: str) -> List[int]:
        ids = []
        for piece in _GPT2_PAT.findall(text):
            mapped = "".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
            for word in self._bpe(mapped):
                tid = self.vocab.get(word)
                ids.append(tid if tid is not None else self.unk_id)
        return ids

    def _bpe(self, word: str) -> List[str]:
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.merge_ranks.get((parts[i], parts[i + 1]), 1 << 30), i)
                     for i in range(len(parts) - 1)]
            rank, i = min(pairs)
            if rank >= 1 << 30:
                break
            parts[i:i + 2] = [parts[i] + parts[i + 1]]
        return parts

    # -- decoding -----------------------------------------------------------

    def decode_token(self, tid: int) -> bytes:
        if tid >= len(self.tokens):
            # tokenizer-less GGUF (or corrupted vocab): degrade to a visible
            # placeholder instead of crashing the stream
            return b"<%d>" % tid
        t = self.tokens[tid]
        ttype = self.token_types[tid]
        if ttype == TOKEN_TYPE_BYTE:
            return bytes([int(t[3:5], 16)])
        if ttype in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN):
            return b""
        if self.model == "gpt2":
            return bytes(_BYTE_DEC.get(c, ord("?")) for c in t)
        return t.replace(SPM_SPACE, " ").encode("utf-8")

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.decode_token(int(t)) for t in ids).decode(
            "utf-8", errors="replace")

    def is_eog(self, tid: int) -> bool:
        return int(tid) in self.eog_ids
