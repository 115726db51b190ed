"""GBNF grammar engine and JSON-schema conversion for constrained decoding.

The port's own copy of llamafile_tpu/runtime/grammar.py (host-only Python),
with llama.cpp's pushdown-stack semantics: a grammar compiles to rules of
element sequences; decoding keeps a set of stacks; a token is admissible
iff its text advances at least one stack, codepoint by codepoint (a piece
of broken UTF-8 is matched by the codepoints it does decode to).

The reference tried every vocabulary entry on every step. Here the
vocabulary's decoded texts form a trie, built once a tokenizer, and
`allowed_tokens` walks it: the stack set after a shared prefix is the same
for every token under it, and a prefix no stack accepts prunes its whole
subtree. The mask is the reference's bit for bit.

Public API:
    g = Grammar.from_gbnf(text)          # or Grammar.from_json_schema(schema)
    s = GrammarSampler(g, tokenizer)
    mask = s.allowed_tokens()            # bool [n_vocab]
    s.accept(token_id)
    s.done                               # root fully matched
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# element kinds
END, ALT, RULE_REF, CHAR, CHAR_NOT, CHAR_RNG_UPPER, CHAR_ALT = range(7)


@dataclass(frozen=True)
class Elem:
    kind: int
    value: int = 0      # codepoint or rule id


Rule = List[Elem]       # sequence ending with END; ALT separates alternates


class GrammarParseError(ValueError):
    pass


class _GbnfParser:
    """GBNF text -> rule table (llama.cpp grammar-parser semantics)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.symbol_ids: Dict[str, int] = {}
        self.rules: Dict[int, Rule] = {}

    def parse(self):
        self._space(True)
        while self.pos < len(self.text):
            self._rule()
            self._space(True)
        for name, rid in self.symbol_ids.items():
            if rid not in self.rules:
                raise GrammarParseError(f"undefined rule '{name}'")
        if "root" not in self.symbol_ids:
            raise GrammarParseError("missing 'root' rule")
        return self.rules, self.symbol_ids["root"]

    # -- lexing helpers -----------------------------------------------------

    def _space(self, newlines: bool):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            elif c == "#":
                while self.pos < len(self.text) and self.text[self.pos] not in "\r\n":
                    self.pos += 1
            else:
                break

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.text) and (self.text[self.pos].isalnum()
                                             or self.text[self.pos] in "-_"):
            self.pos += 1
        if self.pos == start:
            raise GrammarParseError(f"expected name at {start}")
        return self.text[start:self.pos]

    def _sym_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _new_rule(self, base: str) -> int:
        i = 1
        while f"{base}_{i}" in self.symbol_ids:
            i += 1
        return self._sym_id(f"{base}_{i}")

    def _char(self) -> int:
        c = self.text[self.pos]
        if c == "\\":
            self.pos += 1
            e = self.text[self.pos]
            self.pos += 1
            if e in 'x':
                v = int(self.text[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if e == 'u':
                v = int(self.text[self.pos:self.pos + 4], 16)
                self.pos += 4
                return v
            if e == 'U':
                v = int(self.text[self.pos:self.pos + 8], 16)
                self.pos += 8
                return v
            return {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91,
                    "]": 93}.get(e, ord(e))
        self.pos += 1
        return ord(c)

    # -- grammar ------------------------------------------------------------

    def _rule(self):
        name = self._name()
        rid = self._sym_id(name)
        self._space(False)
        if self.text[self.pos:self.pos + 3] != "::=":
            raise GrammarParseError(f"expected ::= after {name}")
        self.pos += 3
        self._space(False)
        self.rules[rid] = self._alternates(name)

    def _alternates(self, base: str) -> Rule:
        out: Rule = []
        self._sequence(base, out)
        self._space(False)
        while self.pos < len(self.text) and self.text[self.pos] == "|":
            self.pos += 1
            self._space(False)
            # skip newline continuation
            while self.pos < len(self.text) and self.text[self.pos] in "\r\n":
                self.pos += 1
                self._space(False)
            out.append(Elem(ALT))
            self._sequence(base, out)
            self._space(False)
        out.append(Elem(END))
        return out

    def _sequence(self, base: str, out: Rule):
        while True:
            self._space(False)
            if self.pos >= len(self.text):
                return
            c = self.text[self.pos]
            start_len = len(out)
            if c == '"':
                self.pos += 1
                while self.text[self.pos] != '"':
                    out.append(Elem(CHAR, self._char()))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                kind = CHAR
                if self.text[self.pos] == "^":
                    kind = CHAR_NOT
                    self.pos += 1
                first = True
                while self.text[self.pos] != "]":
                    v = self._char()
                    out.append(Elem(kind if first else CHAR_ALT, v))
                    first = False
                    if (self.text[self.pos] == "-"
                            and self.text[self.pos + 1] != "]"):
                        self.pos += 1
                        out.append(Elem(CHAR_RNG_UPPER, self._char()))
                self.pos += 1
            elif c.isalnum() or c in "-_":
                name = self._name()
                out.append(Elem(RULE_REF, self._sym_id(name)))
            elif c == "(":
                self.pos += 1
                sub = self._new_rule(base)
                self.rules[sub] = self._alternates(base)
                if self.text[self.pos] != ")":
                    raise GrammarParseError(f"expected ) at {self.pos}")
                self.pos += 1
                out.append(Elem(RULE_REF, sub))
            else:
                return
            # repetition suffix applies to the last element/group
            self._space(False)
            if self.pos < len(self.text) and self.text[self.pos] in "*+?":
                op = self.text[self.pos]
                self.pos += 1
                piece = out[start_len:]
                del out[start_len:]
                sub = self._new_rule(base)
                if op == "*":
                    self.rules[sub] = piece + [Elem(RULE_REF, sub), Elem(ALT), Elem(END)]
                elif op == "+":
                    self.rules[sub] = piece + [Elem(RULE_REF, sub), Elem(ALT)] \
                        + piece + [Elem(END)]
                else:  # ?
                    self.rules[sub] = piece + [Elem(ALT), Elem(END)]
                out.append(Elem(RULE_REF, sub))


class Grammar:
    def __init__(self, rules: Dict[int, Rule], root: int):
        self.rules = rules
        self.root = root
        # split rules into alternates (each a tuple of elems ending at ALT/END)
        self.alts: Dict[int, List[Tuple[Elem, ...]]] = {}
        for rid, rule in rules.items():
            alts, cur = [], []
            for e in rule:
                if e.kind in (ALT, END):
                    alts.append(tuple(cur))
                    cur = []
                else:
                    cur.append(e)
            self.alts[rid] = alts

    @classmethod
    def from_gbnf(cls, text: str) -> "Grammar":
        rules, root = _GbnfParser(text).parse()
        return cls(rules, root)

    @classmethod
    def from_json_schema(cls, schema) -> "Grammar":
        return cls.from_gbnf(json_schema_to_gbnf(schema))


# ---------------------------------------------------------------------------
# Stacks engine
# ---------------------------------------------------------------------------

Stack = Tuple[Tuple[int, int], ...]   # frames of (rule_id·alt packed pos): we
# represent a stack as tuple of (alt_tuple_id) positions; concretely each frame
# is (rule_id, alt_index, elem_index)


def _is_char_elem(e: Elem) -> bool:
    return e.kind in (CHAR, CHAR_NOT)


class _Node:
    """A trie node: the tokens whose text ends here, and the children by
    codepoint."""
    __slots__ = ("ids", "kids")

    def __init__(self):
        self.ids: List[int] = []
        self.kids: Dict[int, "_Node"] = {}


_VOCABS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _token_text(data: bytes) -> str:
    """The codepoints a token's bytes are matched by (the reference's
    _try_bytes): its UTF-8 text, or what decodes of a broken sequence."""
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError:
        return data.decode("utf-8", errors="ignore")


def _vocab(tokenizer):
    """(each token's bytes, the trie of the non-empty texts), made once a
    tokenizer."""
    got = _VOCABS.get(tokenizer)
    if got is None:
        token_bytes = [tokenizer.decode_token(i) for i in range(tokenizer.n_vocab)]
        root = _Node()
        for tid, data in enumerate(token_bytes):
            text = _token_text(data) if data else ""
            if not text:
                continue
            node = root
            for ch in text:
                cp = ord(ch)
                nxt = node.kids.get(cp)
                if nxt is None:
                    nxt = node.kids[cp] = _Node()
                node = nxt
            node.ids.append(tid)
        for node in _nodes(root):
            node.ids = np.asarray(node.ids, np.int64)
        got = _VOCABS[tokenizer] = (token_bytes, root)
    return got


def _nodes(root: _Node):
    todo = [root]
    while todo:
        node = todo.pop()
        yield node
        todo.extend(node.kids.values())


class GrammarSampler:
    """Maintains parse stacks; filters the vocabulary each step."""

    def __init__(self, grammar: Grammar, tokenizer):
        self.g = grammar
        self.tok = tokenizer
        self._token_bytes, self._trie = _vocab(tokenizer)
        self.stacks: List[tuple] = []
        self._push_rule((), self.g.root)

    # stack frame = (rule_id, alt_idx, elem_idx); stack = tuple of frames,
    # top = last. Invariant: top frame points at a char element (or stack empty)

    def _push_rule(self, stack: tuple, rid: int):
        for ai, alt in enumerate(self.g.alts[rid]):
            self._advance_into(stack + ((rid, ai, 0),))

    def _advance_into(self, stack: tuple):
        """Normalize so the top points at a char elem; expand refs/ends."""
        if not stack:
            if stack not in self.stacks:
                self.stacks.append(stack)
            return
        rid, ai, ei = stack[-1]
        alt = self.g.alts[rid][ai]
        if ei >= len(alt):
            # rule finished -> pop and advance caller
            below = stack[:-1]
            if not below:
                if below not in self.stacks:
                    self.stacks.append(below)
                return
            brid, bai, bei = below[-1]
            self._advance_into(below[:-1] + ((brid, bai, bei + 1),))
            return
        e = alt[ei]
        if e.kind == RULE_REF:
            self._push_rule(stack, e.value)
        else:
            if stack not in self.stacks:
                self.stacks.append(stack)

    def _accepts_cp(self, stack: tuple, cp: int) -> Optional[tuple]:
        """If codepoint matches the top char elem, return advanced stack."""
        if not stack:
            return None
        rid, ai, ei = stack[-1]
        alt = self.g.alts[rid][ai]
        e = alt[ei]
        if not _is_char_elem(e):
            return None
        # gather the char-class elements
        j = ei
        match = False
        neg = e.kind == CHAR_NOT
        while j < len(alt):
            ej = alt[j]
            if j > ei and ej.kind not in (CHAR_ALT, CHAR_RNG_UPPER):
                break
            if ej.kind in (CHAR, CHAR_NOT, CHAR_ALT):
                lo = ej.value
                hi = lo
                if j + 1 < len(alt) and alt[j + 1].kind == CHAR_RNG_UPPER:
                    hi = alt[j + 1].value
                    j += 1
                if lo <= cp <= hi:
                    match = True
            j += 1
        if neg:
            match = not match
        if not match:
            return None
        return stack[:-1] + ((rid, ai, j),)

    def _advance_cp(self, stacks: List[tuple], cp: int) -> List[tuple]:
        out: List[tuple] = []
        saved = self.stacks
        self.stacks = out
        for st in stacks:
            adv = self._accepts_cp(st, cp)
            if adv is not None:
                self._advance_into(adv)
        self.stacks = saved
        return out

    def _try_bytes(self, stacks: List[tuple], data: bytes) -> Optional[List[tuple]]:
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            # partial UTF-8 at token boundaries: match complete prefix only
            text = data.decode("utf-8", errors="ignore")
            if not text:
                return None
        cur = stacks
        for ch in text:
            cur = self._advance_cp(cur, ord(ch))
            if not cur:
                return None
        return cur

    def allowed_tokens(self) -> np.ndarray:
        """Bool mask [n_vocab]: token admissible from the current state.
        EOG allowed only when some stack is complete (empty)."""
        mask = np.zeros(self.tok.n_vocab, bool)
        complete = any(len(s) == 0 for s in self.stacks)
        live = [s for s in self.stacks if len(s) > 0]
        if live:
            todo = [(self._trie, live)]
            while todo:
                node, stacks = todo.pop()
                for cp, kid in node.kids.items():
                    nxt = self._advance_cp(stacks, cp)
                    if not nxt:
                        continue
                    if len(kid.ids):
                        mask[kid.ids] = True
                    if kid.kids:
                        todo.append((kid, nxt))
        if complete:
            for e in self.tok.eog_ids:
                mask[e] = True
        return mask

    def accept(self, tid: int) -> None:
        data = self._token_bytes[tid]
        if not data:
            return
        live = [s for s in self.stacks if len(s) > 0]
        nxt = self._try_bytes(live, data)
        if nxt is None:
            raise ValueError(f"token {tid} violates grammar")
        self.stacks = nxt

    @property
    def done(self) -> bool:
        return any(len(s) == 0 for s in self.stacks)


# ---------------------------------------------------------------------------
# JSON schema -> GBNF (subset of llama.cpp json-schema-to-grammar)
# ---------------------------------------------------------------------------

_JSON_PRIMS = {
    "space": r'" "?',
    "string": r'"\"" char* "\"" space',
    "char": r'[^"\\\x00-\x1f] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])',
    "number": r'"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? (("e" | "E") ("-" | "+")? [0-9]+)? space',
    "integer": r'"-"? ([0-9] | [1-9] [0-9]*) space',
    "boolean": r'("true" | "false") space',
    "null": r'"null" space',
    "value": r'object | array | string | number | boolean | null',
    "object": r'"{" space (objpair ("," space objpair)*)? "}" space',
    "objpair": r'string space ":" space value',
    "array": r'"[" space (value ("," space value)*)? "]" space',
}


def _lit(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def json_schema_to_gbnf(schema) -> str:
    """Convert a JSON schema (dict) to GBNF. Supports type/object/properties/
    required/items/enum/const/anyOf plus free-form fallbacks."""
    rules: Dict[str, str] = {}
    counter = [0]

    def visit(s, name: str) -> str:
        if not isinstance(s, dict) or not s:
            return "value"
        if "const" in s:
            import json as _json
            rules[name] = _lit(_json.dumps(s["const"])) + " space"
            return name
        if "enum" in s:
            import json as _json
            alts = " | ".join(_lit(_json.dumps(v)) for v in s["enum"])
            rules[name] = f"({alts}) space"
            return name
        if "anyOf" in s or "oneOf" in s:
            subs = s.get("anyOf", s.get("oneOf"))
            names = [visit(sub, f"{name}a{i}") for i, sub in enumerate(subs)]
            rules[name] = " | ".join(names)
            return name
        t = s.get("type")
        if t == "object" and "properties" in s:
            required = set(s.get("required", list(s["properties"].keys())))
            parts = ['"{" space']
            first = True
            for key, sub in s["properties"].items():
                if key not in required:
                    continue   # v1: emit required properties only
                sub_name = visit(sub, f"{name}_{_safe(key)}")
                sep = "" if first else '"," space '
                key_lit = _lit('"' + key + '"')
                parts.append(f'{sep}{key_lit} space ":" space {sub_name}')
                first = False
            parts.append('"}" space')
            rules[name] = " ".join(parts)
            return name
        if t == "array":
            item = visit(s.get("items", {}), f"{name}_item")
            rules[name] = f'"[" space ({item} ("," space {item})*)? "]" space'
            return name
        if t in ("string", "number", "integer", "boolean", "null"):
            return t
        return "value"

    def _safe(k):
        return "".join(c if c.isalnum() else "_" for c in k)

    def _json_key(k):
        return '\\"' + k + '\\"'

    root = visit(schema if isinstance(schema, dict) else {}, "root")
    lines = []
    if root != "root":
        lines.append(f"root ::= {root}")
    for name, body in rules.items():
        lines.append(f"{name} ::= {body}")
    for name, body in _JSON_PRIMS.items():
        lines.append(f"{name} ::= {body}")
    return "\n".join(lines)
