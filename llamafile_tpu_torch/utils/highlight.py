"""ANSI syntax highlighting for terminal chat output.

The port's own copy of llamafile_tpu/utils/highlight.py (pure Python).
Analog of llamafile/highlight/ (reference: 46 gperf-table lexers feeding the
chatbot's streaming output, highlight/highlight.h). Instead of one generated
C++ state machine per language, a single regex lexer is parameterized by a
per-language spec (keywords, comment styles) — the spec table below covers
the same language set. Streaming-safe: feed() accepts partial text.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

RESET = "\x1b[0m"
BOLD = "\x1b[1m"
KEYWORD = "\x1b[35m"
STRING = "\x1b[32m"
COMMENT = "\x1b[90m"
NUMBER = "\x1b[33m"
TYPE = "\x1b[36m"


@dataclass(frozen=True)
class LangSpec:
    keywords: frozenset
    line_comments: Tuple[str, ...] = ("//",)
    block_comments: Tuple[Tuple[str, str], ...] = (("/*", "*/"),)
    case_insensitive: bool = False


def _spec(kw: str, line=("//",), block=(("/*", "*/"),), ci=False) -> LangSpec:
    return LangSpec(frozenset(kw.split()), tuple(line), tuple(block), ci)


_C_KW = ("int char long short float double void unsigned signed struct union "
         "enum typedef static extern const volatile return if else for while "
         "do switch case default break continue goto sizeof inline auto "
         "register restrict bool true false NULL")

_SPECS: Dict[str, LangSpec] = {
    # -- scripting ----------------------------------------------------------
    "python": _spec("def class return if elif else for while import from as "
                    "with try except finally lambda yield pass break continue "
                    "in is not and or None True False async await raise "
                    "global nonlocal del assert match case self print",
                    line=("#",), block=()),
    "javascript": _spec("function var let const return if else for while do "
                        "switch case default break continue new delete typeof "
                        "instanceof in of class extends super this null "
                        "undefined true false async await yield import export "
                        "try catch finally throw static get set"),
    "typescript": _spec("function var let const return if else for while do "
                        "switch case default break continue new typeof class "
                        "extends implements interface type enum namespace "
                        "declare readonly public private protected abstract "
                        "this null undefined true false async await import "
                        "export try catch finally throw as keyof infer never "
                        "unknown any string number boolean void"),
    "ruby": _spec("def class module end if elsif else unless case when while "
                  "until for in do return yield begin rescue ensure raise "
                  "require attr_accessor attr_reader puts lambda proc self "
                  "nil true false and or not then break next redo retry",
                  line=("#",), block=(("=begin", "=end"),)),
    "perl": _spec("my our local sub if elsif else unless while until for "
                  "foreach do last next redo return use require package bless "
                  "print printf die warn defined undef eq ne lt gt and or not",
                  line=("#",), block=()),
    "php": _spec("function class interface trait extends implements public "
                 "private protected static const return if elseif else "
                 "switch case default for foreach while do break continue "
                 "new clone echo print use namespace require include try "
                 "catch finally throw null true false as instanceof",
                 line=("//", "#")),
    "lua": _spec("function local end if then elseif else for while repeat "
                 "until do return break in pairs ipairs nil true false and "
                 "or not require", line=("--",), block=(("--[[", "]]"),)),
    "shell": _spec("if then else elif fi for while do done case esac function "
                   "return exit echo cd export local readonly set unset shift "
                   "source alias trap eval exec test in", line=("#",),
                   block=()),
    "tcl": _spec("proc set if else elseif while for foreach switch return "
                 "break continue expr puts source package namespace variable "
                 "global upvar uplevel", line=("#",), block=()),
    "r": _spec("function if else for while repeat break next return library "
               "require TRUE FALSE NULL NA Inf NaN in", line=("#",), block=()),
    "matlab": _spec("function end if elseif else for while switch case "
                    "otherwise break continue return global persistent true "
                    "false classdef properties methods", line=("%",),
                    block=(("%{", "%}"),)),
    "basic": _spec("dim as if then else elseif end sub function for to step "
                   "next while wend do loop select case print input let goto "
                   "gosub return rem and or not mod integer string double",
                   line=("'",), block=(), ci=True),
    # -- systems ------------------------------------------------------------
    "c": _spec(_C_KW),
    "cpp": _spec(_C_KW + " class namespace template typename public private "
                 "protected virtual override final new delete this operator "
                 "friend using constexpr decltype nullptr try catch throw"),
    "csharp": _spec("using namespace class struct interface enum public "
                    "private protected internal static readonly const return "
                    "if else for foreach while do switch case default break "
                    "continue new this null true false var string int long "
                    "bool void async await try catch finally throw get set "
                    "override virtual abstract sealed partial record"),
    "java": _spec("package import class interface enum extends implements "
                  "public private protected static final abstract return if "
                  "else for while do switch case default break continue new "
                  "this null true false void int long double boolean char "
                  "try catch finally throw throws synchronized volatile "
                  "instanceof record var"),
    "kotlin": _spec("fun val var class object interface enum data sealed "
                    "return if else for while when break continue in is as "
                    "null true false package import this super open override "
                    "abstract companion lateinit by lazy suspend"),
    "swift": _spec("func var let class struct enum protocol extension return "
                   "if else guard for while switch case default break "
                   "continue in is as nil true false import self super init "
                   "deinit throws try catch defer public private internal "
                   "open static lazy weak unowned"),
    "rust": _spec("fn let mut const static struct enum trait impl for while "
                  "loop if else match return use mod pub crate self super "
                  "where async await move ref box dyn type unsafe extern "
                  "true false Some None Ok Err as in break continue"),
    "go": _spec("func var const type struct interface map chan go defer "
                "return if else for range switch case default break continue "
                "package import select fallthrough goto nil true false make "
                "new len cap append"),
    "zig": _spec("fn var const pub return if else while for switch break "
                 "continue defer errdefer try catch orelse struct enum union "
                 "error test comptime inline export extern null undefined "
                 "true false and or"),
    "d": _spec("void int long float double char bool struct class interface "
               "enum union template mixin return if else for foreach while "
               "do switch case default break continue import module public "
               "private immutable const auto this super null true false"),
    "asm": _spec("mov add sub mul div push pop call ret jmp je jne jz jnz jg "
                 "jl jge jle cmp test lea xor and or not shl shr inc dec nop "
                 "int syscall section global extern db dw dd dq",
                 line=(";", "#"), block=(), ci=True),
    # -- classic ------------------------------------------------------------
    "pascal": _spec("program begin end procedure function var const type if "
                    "then else for to downto do while repeat until case of "
                    "record array set integer real string boolean true false "
                    "nil unit interface implementation uses",
                    line=("//",), block=(("{", "}"), ("(*", "*)")), ci=True),
    "fortran": _spec("program subroutine function end if then else elseif "
                     "endif do while call return integer real character "
                     "logical complex dimension allocate deallocate module "
                     "use implicit none contains intent in out inout",
                     line=("!",), block=(), ci=True),
    "cobol": _spec("identification division program-id procedure data "
                   "working-storage section perform move add subtract "
                   "multiply divide compute display accept if else end-if "
                   "until varying stop run pic value occurs",
                   line=("*>",), block=(), ci=True),
    "ada": _spec("procedure function package body begin end is if then else "
                 "elsif case when loop while for in out return declare type "
                 "subtype record array access constant with use null true "
                 "false new raise exception others",
                 line=("--",), block=(), ci=True),
    "forth": _spec("if else then begin until while repeat do loop dup "
                   "drop swap over rot emit cr variable constant create "
                   "allot cells", line=("\\",), block=(("(", ")"),)),
    # -- functional ---------------------------------------------------------
    "haskell": _spec("module import data type newtype class instance where "
                     "let in do case of if then else deriving return IO "
                     "Maybe Just Nothing Either Left Right map filter foldr",
                     line=("--",), block=(("{-", "-}"),)),
    "ocaml": _spec("let rec in fun function match with type module struct "
                   "sig end if then else begin open exception raise try "
                   "mutable ref true false None Some",
                   line=(), block=(("(*", "*)"),)),
    "lisp": _spec("defun defvar defparameter defmacro let let* lambda if "
                  "when unless cond case loop dolist dotimes setq setf progn "
                  "car cdr cons list quote nil t format",
                  line=(";",), block=(("#|", "|#"),)),
    "scheme": _spec("define lambda let let* letrec if cond case when unless "
                    "begin set! quote quasiquote car cdr cons list null? "
                    "pair? map for-each display", line=(";",), block=()),
    "clojure": _spec("defn def defmacro let fn if when cond case loop recur "
                     "do doseq dotimes map filter reduce conj assoc dissoc "
                     "nil true false ns require",
                     line=(";",), block=()),
    "erlang": _spec("module export import fun case of if end when receive "
                    "after spawn self true false andalso orelse div rem",
                    line=("%",), block=()),
    "elixir": _spec("defmodule def defp defmacro do end if else unless case "
                    "cond fn when import require use alias true false nil "
                    "receive after spawn", line=("#",), block=()),
    "scala": _spec("def val var class object trait extends with if else for "
                   "while match case yield return import package new this "
                   "super null true false implicit override sealed abstract "
                   "final lazy type"),
    "julia": _spec("function end if elseif else for while break continue "
                   "return begin let local global const struct mutable "
                   "abstract type using import module export true false "
                   "nothing missing", line=("#",), block=(("#=", "=#"),)),
    # -- data / markup ------------------------------------------------------
    "sql": _spec("select from where insert into values update set delete "
                 "create table drop alter index join left right inner outer "
                 "on as and or not null primary key foreign references group "
                 "by order limit having union all distinct between like in "
                 "exists case when then else end",
                 line=("--",), ci=True),
    "html": _spec("html head body div span a img script style link meta "
                  "table tr td th ul ol li form input button class id href "
                  "src", line=(), block=(("<!--", "-->"),), ci=True),
    "css": _spec("color background margin padding border display position "
                 "width height font-size font-family flex grid none block "
                 "inline absolute relative fixed hover root important",
                 line=(), block=(("/*", "*/"),)),
    "json": _spec("true false null", line=(), block=()),
    "yaml": _spec("true false null yes no on off", line=("#",), block=(),
                  ci=True),
    "toml": _spec("true false", line=("#",), block=()),
    "markdown": _spec("", line=(), block=()),
    "makefile": _spec("ifeq ifneq ifdef ifndef else endif include export "
                      "define endef all clean install phony",
                      line=("#",), block=()),
    "cmake": _spec("cmake_minimum_required project add_executable "
                   "add_library target_link_libraries set if else endif "
                   "foreach endforeach function endfunction include "
                   "find_package message option install",
                   line=("#",), block=(), ci=True),
    "dockerfile": _spec("from run cmd entrypoint copy add env arg expose "
                        "workdir user volume label shell healthcheck onbuild "
                        "stopsignal as", line=("#",), block=(), ci=True),
    "tex": _spec("documentclass usepackage begin end section subsection "
                 "textbf textit item label ref cite includegraphics frac",
                 line=("%",), block=()),
}

_ALIASES = {
    "py": "python", "python3": "python",
    "js": "javascript", "jsx": "javascript", "node": "javascript",
    "ts": "typescript", "tsx": "typescript",
    "c++": "cpp", "cc": "cpp", "cxx": "cpp", "h": "c", "hpp": "cpp",
    "cs": "csharp", "c#": "csharp",
    "bash": "shell", "sh": "shell", "zsh": "shell", "ksh": "shell",
    "golang": "go", "rb": "ruby", "pl": "perl", "kt": "kotlin",
    "rs": "rust", "hs": "haskell", "ml": "ocaml", "clj": "clojure",
    "ex": "elixir", "exs": "elixir", "erl": "erlang", "jl": "julia",
    "m": "matlab", "octave": "matlab", "f90": "fortran", "f": "fortran",
    "adb": "ada", "fs": "forth", "4th": "forth", "nasm": "asm", "s": "asm",
    "xml": "html", "htm": "html", "svg": "html", "md": "markdown",
    "mk": "makefile", "make": "makefile", "docker": "dockerfile",
    "latex": "tex", "el": "lisp", "elisp": "lisp", "commonlisp": "lisp",
    "vb": "basic", "vba": "basic", "qbasic": "basic",
    "postgres": "sql", "mysql": "sql", "sqlite": "sql", "psql": "sql",
}


def get_spec(lang: Optional[str]) -> Optional[LangSpec]:
    name = (lang or "").lower()
    return _SPECS.get(_ALIASES.get(name, name))


def supported_languages() -> List[str]:
    return sorted(_SPECS)


def _token_re(spec: LangSpec) -> re.Pattern:
    parts = []
    com = [re.escape(c) + r"[^\n]*" for c in spec.line_comments]
    com += [re.escape(a) + r".*?" + re.escape(b)
            for a, b in spec.block_comments]
    if com:
        parts.append("(?P<comment>" + "|".join(com) + ")")
    parts.append(r"(?P<string>\"(?:\\.|[^\"\\])*\"|'(?:\\.|[^'\\])*')")
    parts.append(r"(?P<number>\b\d+(?:\.\d+)?(?:[eE][+-]?\d+)?\b|\b0[xX][0-9a-fA-F]+\b)")
    parts.append(r"(?P<word>\b[\w#-]+\b)")
    return re.compile("|".join(parts), re.S)


_RE_CACHE: Dict[int, re.Pattern] = {}


def highlight_code(code: str, lang: Optional[str]) -> str:
    spec = get_spec(lang)
    if spec is None:
        return code
    rx = _RE_CACHE.get(id(spec))
    if rx is None:
        rx = _RE_CACHE[id(spec)] = _token_re(spec)

    def repl(m: re.Match) -> str:
        g = m.groupdict()
        if g.get("comment"):
            return f"{COMMENT}{m.group(0)}{RESET}"
        if g.get("string"):
            return f"{STRING}{m.group(0)}{RESET}"
        if g.get("number"):
            return f"{NUMBER}{m.group(0)}{RESET}"
        w = m.group("word")
        probe = w.lower() if spec.case_insensitive else w
        if probe in spec.keywords:
            return f"{KEYWORD}{w}{RESET}"
        return w

    return rx.sub(repl, code)


class StreamHighlighter:
    """Streaming markdown-ish highlighter: colorize fenced code blocks.

    feed(piece) returns text to print (may buffer partial fence markers)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.buf = ""
        self.in_code = False
        self.lang: Optional[str] = None

    def feed(self, piece: str) -> str:
        if not self.enabled:
            return piece
        self.buf += piece
        out = []
        while True:
            idx = self.buf.find("```")
            if idx < 0:
                # keep a possible partial fence in the buffer
                keep = 0
                for k in (2, 1):
                    if self.buf.endswith("`" * k):
                        keep = k
                        break
                emit, self.buf = self.buf[: len(self.buf) - keep], \
                    self.buf[len(self.buf) - keep:]
                out.append(highlight_code(emit, self.lang) if self.in_code else emit)
                return "".join(out)
            head, rest = self.buf[:idx], self.buf[idx + 3:]
            out.append(highlight_code(head, self.lang) if self.in_code else head)
            if self.in_code:
                self.in_code = False
                self.lang = None
                out.append("```")
                self.buf = rest
            else:
                nl = rest.find("\n")
                if nl < 0:      # language line not complete yet
                    self.buf = "```" + rest
                    return "".join(out)
                self.lang = rest[:nl].strip() or None
                self.in_code = True
                out.append("```" + rest[: nl + 1])
                self.buf = rest[nl + 1:]

    def flush(self) -> str:
        emit = highlight_code(self.buf, self.lang) if self.in_code else self.buf
        self.buf = ""
        return emit
