"""Command line of the port: the program mux, the terminal chatbot, raw
completion, the HTTP server and the tokenizer dump.

  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." -n 32
  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." --device cpu
      [--kv-dtype bf16|f16|f32|int8] [--prompt-cache session.npz]
      [--trace trace.json] [--trap]
      [--repeat-penalty 1.1 --repeat-last-n 64] [--mirostat 2]
  python -m llamafile_tpu_torch.cli --model m.gguf --chat [--device cpu]
  python -m llamafile_tpu_torch.cli --model m.gguf --chat --server \
      --listen 127.0.0.1:8080
  python -m llamafile_tpu_torch.cli --server -m m.gguf --slots 8 \
      --listen 127.0.0.1:8080 [--ctx-size N] [--kv-dtype bf16|f16|f32|int8] \
      [--preempt SECONDS] [--db chats.sqlite] [--www-root DIR] [--device cpu]
  python -m llamafile_tpu_torch.cli --tokenize -m m.gguf -p "text"
  python -m llamafile_tpu_torch.cli --version

Counterpart of llamafile_tpu/cli.py. Every mode reads the one flag table
of utils/flags.py and runs on the card unless `--device cpu` is given; with
no mode flag the chatbot runs when stdin is a terminal, `--cli` otherwise.
`--cli` carries the penalty window and mirostat through Engine.generate's
decode, and `--prompt-cache` reuses and saves the prompt's KV state
(runtime/state.py). `--chat` keeps one KV cache across the turns
(runtime.engine.ChatSession) and takes the reference's slash commands;
with `--server` the HTTP server runs on a background thread over the
chat's engine. `--trace PATH` writes utils/tracing's span recorder as
Chrome JSON at exit, `--trap` holds every forward's layer outputs and
logits to be finite (FloatingPointError at the first that is not). Left
out: image input (`--image`, and `/upload` of an image with `--mmproj`, which
prints that it is not ported), LoRA, self-extend and multi-chip meshes.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, TextIO

from .utils.flags import Flags, parse_flags
from .version import VERSION_STRING


def _load_engine(flags: Flags):
    from .runtime.engine import load_engine
    t0 = time.time()
    eng = load_engine(flags.model, device=flags.device,
                      max_seq_len=flags.ctx_size, kv_dtype=flags.kv_dtype)
    print(f"loaded {flags.model}: {eng.cfg.n_layers}L d{eng.cfg.d_model} "
          f"vocab {eng.cfg.n_vocab} on {eng.device} in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return eng


def run_cli(flags: Flags) -> int:
    try:
        eng = _load_engine(flags)
        n = flags.n_predict if flags.n_predict > 0 else 128
        t0 = time.time()
        count = 0
        for _tid, piece in eng.generate(flags.prompt or "", max_tokens=n,
                                        sampling=flags.sampling(),
                                        prompt_cache=flags.prompt_cache or None):
            sys.stdout.write(piece)
            sys.stdout.flush()
            count += 1
    except NotImplementedError as e:
        print(f"\nerror: {e}", file=sys.stderr)
        return 1
    dt = time.time() - t0
    print(f"\n[{count} tokens, {count / max(dt, 1e-9):.1f} tok/s]", file=sys.stderr)
    return 0


HELP = """\
slash commands (reference: llamafile chatbot_help.cpp):
  /help            show this help
  /context         print context-window usage
  /stats           print timing statistics
  /clear           wipe conversation history
  /undo            remove last exchange
  /forget          drop oldest exchange
  /push /pop       save/restore a conversation checkpoint
  /stack           print the checkpoint stack
  /upload FILE     share a text file (or image, with --mmproj) with the model
  /exit            quit
"""

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".webp")


def _upload_file(path: str, messages: List[dict], flags: Flags) -> str:
    """/upload FILE: a text file becomes a readonly markdown system message
    with its content and size (the reference's text); an image needs
    --mmproj, and image input is not ported."""
    if not os.path.exists(path):
        return f"no such file: {path}"
    ext = os.path.splitext(path)[1].lower()
    if ext in _IMAGE_EXTS:
        if not flags.mmproj:
            return "image upload needs --mmproj (clip vision model)"
        return ("image input (--mmproj, the clip vision model) is not ported "
                "to llamafile_tpu_torch yet")
    with open(path, "rb") as f:
        data = f.read()
    if b"\x00" in data:
        return "files with NUL characters are not supported"
    text = data.decode("utf-8", errors="replace")
    st = os.stat(path)
    lang = {".py": "python", ".c": "c", ".cpp": "cpp", ".js": "javascript",
            ".md": "markdown", ".json": "json", ".sh": "bash"}.get(ext, "")
    messages.append({"role": "system", "content":
                     f"The user shared the file `{path}` "
                     f"({st.st_size} bytes). You have readonly access to its "
                     f"content:\n\n```{lang}\n{text}\n```"})
    return f"shared {path} ({st.st_size} bytes) with the assistant"


def chat_loop(eng, flags: Flags, inp: TextIO, out: TextIO,
              session=None) -> int:
    """The chatbot's REPL over a built engine: reads lines from inp, writes
    the prompt, the replies and the commands' answers to out (the
    reference's texts). Returns 0 on /exit or at the end of inp."""
    from .runtime.chat import apply_chat_template
    from .runtime.engine import ChatSession
    from .utils.highlight import StreamHighlighter
    session = session or ChatSession(eng)     # KV kept across turns
    tok = eng.tokenizer
    say = lambda text="": print(text, file=out)
    messages: List[dict] = []
    stack: List[int] = []
    stats = {"tokens": 0, "seconds": 0.0}
    while True:
        out.write(">>> ")
        out.flush()
        try:
            line = inp.readline()
        except KeyboardInterrupt:
            line = ""
        if not line:
            say()
            return 0
        line = line.strip()
        if not line:
            continue
        if line.startswith("/"):
            cmd = line.split()[0]
            if cmd in ("/exit", "/quit", "/bye"):
                return 0
            if cmd == "/help":
                say(HELP)
            elif cmd == "/clear":
                messages.clear()
                say("cleared")
            elif cmd == "/undo":
                while messages and messages[-1]["role"] != "user":
                    messages.pop()
                if messages:
                    messages.pop()
                say("undone")
            elif cmd == "/forget":
                del messages[:2]
                say("forgot oldest exchange")
            elif cmd == "/push":
                stack.append(len(messages))
                say(f"pushed @{len(messages)}")
            elif cmd == "/pop":
                if stack:
                    del messages[stack.pop():]
                    say("popped")
                else:
                    say("stack empty")
            elif cmd == "/stack":
                if stack:
                    for i, off in enumerate(stack):
                        say(f"  [{i}] @{off} messages")
                else:
                    say("stack empty")
            elif cmd == "/upload":
                parts = line.split(maxsplit=1)
                say(_upload_file(parts[1], messages, flags)
                    if len(parts) == 2 else "usage: /upload FILE")
            elif cmd == "/context":
                prompt = apply_chat_template(messages, tok.chat_template)
                say(f"{len(tok.encode(prompt))}/{eng.max_seq_len} tokens used")
            elif cmd == "/stats":
                s = stats["seconds"] or 1e-9
                say(f"{stats['tokens']} tokens in {stats['seconds']:.1f}s "
                    f"({stats['tokens'] / s:.1f} tok/s)")
            else:
                say(f"unknown command {cmd} (try /help)")
            continue
        messages.append({"role": "user", "content": line})
        t0 = time.time()
        reply = []
        isatty = getattr(out, "isatty", None)
        hl = StreamHighlighter(enabled=bool(isatty and isatty()))
        n = flags.n_predict if flags.n_predict > 0 else 512
        prompt = apply_chat_template(messages, tok.chat_template)
        for _tid, piece in session.generate(tok.encode(prompt), max_tokens=n,
                                            sampling=flags.sampling()):
            out.write(hl.feed(piece))
            out.flush()
            reply.append(piece)
        out.write(hl.flush())
        say()
        stats["tokens"] += len(reply)
        stats["seconds"] += time.time() - t0
        messages.append({"role": "assistant", "content": "".join(reply)})


def serve_in_background(flags: Flags, eng):
    """The HTTP server on a daemon thread over eng (the reference's --chat
    --server). Returns the Server."""
    import asyncio
    import threading
    from .server.http import Server, _amain
    host, _, port = flags.listen.rpartition(":")
    srv = Server(flags, eng)

    def _serve():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(_amain(srv, host or "127.0.0.1", int(port)))

    threading.Thread(target=_serve, daemon=True, name="http").start()
    print(f"server listening on http://{flags.listen}/ (background)",
          file=sys.stderr)
    return srv


def run_chat(flags: Flags, with_server: bool = False) -> int:
    try:  # history and line editing on a terminal
        import readline  # noqa: F401
    except ImportError:
        pass
    eng = _load_engine(flags)
    srv = serve_in_background(flags, eng) if with_server else None
    print(f"llamafile-tpu {VERSION_STRING} chat — /help for commands",
          file=sys.stderr)
    try:
        return chat_loop(eng, flags, sys.stdin, sys.stdout)
    finally:
        if srv is not None:
            srv.shutdown()


def run_tokenize(flags: Flags) -> int:
    from .gguf.reader import GGUFReader
    from .runtime.tokenizer import Tokenizer
    tok = Tokenizer(GGUFReader(flags.model).metadata)
    for tid in tok.encode(flags.prompt or ""):
        print(f"{tid}\t{tok.tokens[tid]!r}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "chat" if sys.stdin.isatty() else "cli"
    seen = []
    for m in ("cli", "chat", "server", "tokenize", "version"):
        if f"--{m}" in argv:
            argv.remove(f"--{m}")
            mode = m
            seen.append(m)
    # --chat --server together: the REPL with the HTTP server beside it
    chat_with_server = set(seen) >= {"chat", "server"}
    if chat_with_server:
        mode = "chat"
    if mode == "version":
        print(VERSION_STRING)
        return 0
    flags = parse_flags(argv)
    if not flags.model:
        print("error: --model required", file=sys.stderr)
        return 1
    if flags.trap:
        from .utils.tracing import enable_trap
        enable_trap()
        print("NaN/Inf trapping enabled (--trap)", file=sys.stderr)
    if flags.trace:
        import atexit
        from .utils import tracing
        tracer = tracing.enable_tracing(flags.trace)
        atexit.register(tracer.write)
        print(f"tracing to {flags.trace} (Chrome about://tracing)", file=sys.stderr)
    if mode == "cli":
        return run_cli(flags)
    if mode == "chat":
        return run_chat(flags, with_server=chat_with_server)
    if mode == "tokenize":
        return run_tokenize(flags)
    from .server.http import serve
    return serve(flags)


if __name__ == "__main__":
    sys.exit(main())
