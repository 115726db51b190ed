"""The port's GBNF engine (llamafile_tpu_torch/runtime/grammar.py) against
the JAX package's: the same grammars give the same rule tables and parse
errors, and along accepted token sequences `allowed_tokens()` gives the
reference's mask bit for bit, over a byte vocabulary and over one with
multi-byte, multi-codepoint and broken UTF-8 pieces (the port walks a trie
of the pieces' texts; the reference tries every piece).
"""

import numpy as np
import pytest

from llamafile_tpu.runtime import grammar as JG
from llamafile_tpu_torch.runtime import grammar as TG

# the grammars of tests/test_grammar.py, and a few more
GBNF = {
    "literal": 'root ::= "hello"',
    "alternates": 'root ::= ("a" | [0-9]+) "!"',
    "star": 'root ::= "x" [a-c]* "y"',
    "recursion": '''
root ::= expr
expr ::= term ("+" term)*
term ::= [0-9]+ | "(" expr ")"
''',
    "violation": 'root ::= "ab"',
    "negated_class": 'root ::= "[" [^\\]\\n]* "]" [ \\t]?',
    "optional_unicode": 'root ::= "caf" ("e" | "\\u00e9") "s"? "\\u20ac" # comment',
    "items": 'root ::= item item item\nitem ::= "<1" [0-9] [0-9] ">"',
}

SCHEMAS = {
    "object": {"type": "object",
               "properties": {"name": {"type": "string"},
                              "age": {"type": "integer"}},
               "required": ["name", "age"]},
    "enum_array": {"type": "object",
                   "properties": {"color": {"enum": ["red", "green"]},
                                  "nums": {"type": "array",
                                           "items": {"type": "integer"}}},
                   "required": ["color", "nums"]},
    "boolean": {"type": "object", "properties": {"ok": {"type": "boolean"}},
                "required": ["ok"]},
    # nested: an object in an array in an object, an enum, a required key
    # (the optional one is left out of the grammar, as the reference does)
    "nested": {"type": "object", "properties": {
        "id": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "object", "properties": {
            "k": {"enum": ["a", "b", 3, None]},
            "v": {"type": "number"}}, "required": ["k", "v"]}},
        "note": {"type": "string"},
        "kind": {"const": "x"}}, "required": ["id", "tags", "kind"]},
    "free": {},
}

BAD_GBNF = ['root ::= "a" | foo', 'rot ::= "a"', 'root "a"', 'root ::= ("a" "b"',
            '::= "a"', 'root ::= "a"\nroot2 ::= bar']


class Vocab:
    """A tokenizer stand-in: token i decodes to pieces[i]; EOG decodes to
    nothing."""

    def __init__(self, pieces, eog):
        self.pieces = pieces
        self.n_vocab = len(pieces)
        self.eog_ids = set(eog)

    def decode_token(self, tid):
        return self.pieces[tid]

    def is_eog(self, tid):
        return tid in self.eog_ids


def byte_vocab():
    return Vocab([bytes([i]) for i in range(256)] + [b""], [256])


def mixed_vocab(seed=0):
    """Single bytes (0x80-0xff are broken UTF-8 alone), multi-byte
    characters whole and cut, pieces that end or start inside a character,
    JSON-ish multi-character pieces, duplicates, an empty control piece and
    two EOG pieces (one empty, one with text)."""
    rng = np.random.default_rng(seed)
    pieces = [bytes([i]) for i in range(256)]
    pieces += [c.encode() for c in "é€😀ü"]
    pieces += ["é".encode()[:1], "€".encode()[:2], "😀".encode()[:3],
               b"a\xff", b"\xa9s", "caf".encode() + "é".encode()[:1],
               "é".encode()[1:] + b"s\xe2\x82", b"\xac", "café".encode()]
    alphabet = list('{}[]",: 0123456789abcdefghijklmnoprstuvxy+()!<>-.\\')
    alphabet += ["é", "€", "\n"]
    for _ in range(300):
        n = int(rng.integers(2, 7))
        pieces.append("".join(rng.choice(alphabet, n)).encode())
    pieces += [b'{"', b'": ', b'true', b'false', b'null', b'"red"', b'green"',
               b"<123>", b"<1", b"99>", b"<19>", b"ab", b"ab", b""]
    eog = [len(pieces), len(pieces) + 1]
    pieces += [b"", b"</s>"]
    return Vocab(pieces, eog)


def _grammars(name):
    if name in GBNF:
        return JG.Grammar.from_gbnf(GBNF[name]), TG.Grammar.from_gbnf(GBNF[name])
    return (JG.Grammar.from_json_schema(SCHEMAS[name]),
            TG.Grammar.from_json_schema(SCHEMAS[name]))


def _walk(name, vocab, seed, steps=40):
    """Accept random admissible tokens (prefer non-EOG), holding the masks
    equal at every step; returns the number of steps taken."""
    jg, tg = _grammars(name)
    js, ts = JG.GrammarSampler(jg, vocab), TG.GrammarSampler(tg, vocab)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        want, got = js.allowed_tokens(), ts.allowed_tokens()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{name} step {step}")
        assert ts.done == js.done
        ok = [t for t in np.nonzero(want)[0] if t not in vocab.eog_ids]
        if not ok:
            return step
        tid = int(rng.choice(ok))
        js.accept(tid)
        ts.accept(tid)
        assert ts.stacks == js.stacks
    return steps


@pytest.mark.parametrize("name", sorted(GBNF) + sorted(SCHEMAS))
def test_same_rules(name):
    if name in GBNF:
        jr, jroot = JG._GbnfParser(GBNF[name]).parse()
        tr, troot = TG._GbnfParser(GBNF[name]).parse()
    else:
        assert TG.json_schema_to_gbnf(SCHEMAS[name]) == JG.json_schema_to_gbnf(SCHEMAS[name])
        text = JG.json_schema_to_gbnf(SCHEMAS[name])
        jr, jroot = JG._GbnfParser(text).parse()
        tr, troot = TG._GbnfParser(text).parse()
    assert troot == jroot
    assert {k: [(e.kind, e.value) for e in v] for k, v in tr.items()} == \
        {k: [(e.kind, e.value) for e in v] for k, v in jr.items()}


@pytest.mark.parametrize("vocab", ["byte", "mixed"])
@pytest.mark.parametrize("name", sorted(GBNF) + sorted(SCHEMAS))
def test_masks_equal_along_accepted_tokens(name, vocab):
    v = byte_vocab() if vocab == "byte" else mixed_vocab()
    for seed in range(3 if vocab == "byte" else 2):
        _walk(name, v, seed)


def test_json_object_walk_reaches_done():
    """A walk over the mixed vocabulary that completes the object, so the
    EOG pieces' mask bits are held too."""
    v = mixed_vocab()
    jg, tg = _grammars("boolean")
    js, ts = JG.GrammarSampler(jg, v), TG.GrammarSampler(tg, v)
    for piece in (b'{"', b"o", b"k", b'": ', b"true", b"}"):
        tid = v.pieces.index(piece)
        np.testing.assert_array_equal(ts.allowed_tokens(), js.allowed_tokens())
        js.accept(tid)
        ts.accept(tid)
    assert ts.done and js.done
    mask = ts.allowed_tokens()
    np.testing.assert_array_equal(mask, js.allowed_tokens())
    assert all(mask[e] for e in v.eog_ids)


@pytest.mark.parametrize("text", BAD_GBNF)
def test_same_parse_errors(text):
    def err(mod):
        try:
            mod.Grammar.from_gbnf(text)
        except Exception as e:     # noqa: BLE001 — compared by type and text
            return type(e).__name__, str(e)
        return None
    want = err(JG)
    assert want is not None and err(TG) == want


def test_violation_raises_and_port_error_class():
    s = TG.GrammarSampler(TG.Grammar.from_gbnf('root ::= "ab"'), byte_vocab())
    s.accept(ord("a"))
    with pytest.raises(ValueError):
        s.accept(ord("x"))
    assert issubclass(TG.GrammarParseError, ValueError)
    with pytest.raises(TG.GrammarParseError, match="undefined rule"):
        TG.Grammar.from_gbnf("root ::= missing")


def test_trie_is_built_once_a_tokenizer():
    v = mixed_vocab()
    g = TG.Grammar.from_gbnf(GBNF["literal"])
    a, b = TG.GrammarSampler(g, v), TG.GrammarSampler(g, v)
    assert a._trie is b._trie and a._token_bytes is b._token_bytes
