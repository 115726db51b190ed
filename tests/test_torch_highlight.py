"""The port's copy of the chat's syntax highlighter against the JAX
package's: the same ANSI output on the cases of tests/test_highlight.py
and on every language (pure Python on both sides, so equal text)."""
import pytest

from llamafile_tpu.utils import highlight as J
from llamafile_tpu_torch.utils import highlight as T

SNIPPET = ("x = 42 # note\n// line\n/* block */ -- dash\n"
           "'s' \"t\" `u` 0x1F 3.5e-2 if while return end\n")


def _stream(mod, text, step, enabled=True):
    hl = mod.StreamHighlighter(enabled=enabled)
    out = ""
    for i in range(0, len(text), step):
        out += hl.feed(text[i:i + step])
    return out + hl.flush()


def test_tables_equal():
    assert T.supported_languages() == J.supported_languages()
    assert T._ALIASES == J._ALIASES
    for name in ("RESET", "BOLD", "KEYWORD", "STRING", "COMMENT", "NUMBER", "TYPE"):
        assert getattr(T, name) == getattr(J, name)
    for lang in J.supported_languages():
        t, j = T.get_spec(lang), J.get_spec(lang)
        assert (t.keywords, t.line_comments, t.block_comments) == \
            (j.keywords, j.line_comments, j.block_comments), lang


@pytest.mark.parametrize("code,lang", [
    ("def foo(): return 1", "python"), ("def x", "klingon"),
    ("x = 1", None), ("SELECT * FROM t -- c", "sql")])
def test_highlight_code_cases(code, lang):
    assert T.highlight_code(code, lang) == J.highlight_code(code, lang)


def test_every_language_same_output():
    for lang in J.supported_languages():
        spec = J.get_spec(lang)
        cases = [SNIPPET, "a 123 b"]
        if spec.keywords:
            cases.append(f"x {sorted(spec.keywords)[0]} y")
        cases += [f"{lc} note\n" for lc in spec.line_comments]
        cases += [f"{a} note {b}" for a, b in spec.block_comments]
        for code in cases:
            assert T.highlight_code(code, lang) == J.highlight_code(code, lang), (lang, code)
    for alias in J._ALIASES:
        assert T.highlight_code(SNIPPET, alias) == J.highlight_code(SNIPPET, alias), alias


@pytest.mark.parametrize("step", [1, 3, 7, 1000])
@pytest.mark.parametrize("text", [
    "look:\n```python\ndef f():\n    return 'hi'\n```\ndone",
    "return of the jedi",
    "a\n```js\nconst x = 1; // c\n```\n```\nplain fence\n```\n```rust\nfn main() {",
    "``` \n```c\nint main(void) { return 0; } /* x */\n```"])
def test_stream_same_output(text, step):
    assert _stream(T, text, step) == _stream(J, text, step)
    assert _stream(T, text, step, enabled=False) == _stream(J, text, step, enabled=False)
