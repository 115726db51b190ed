"""Command line of the port: raw completion and the HTTP server.

  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." -n 32
  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." --device cpu
      [--kv-dtype bf16|int8] [--prompt-cache session.npz]
      [--repeat-penalty 1.1 --repeat-last-n 64] [--mirostat 2]
  python -m llamafile_tpu_torch.cli --server -m m.gguf --slots 8 \
      --listen 127.0.0.1:8080 [--ctx-size N] [--kv-dtype bf16|int8] \
      [--preempt SECONDS] [--device cpu] [--temp ... sampling defaults]

Counterpart of the `--cli` and `--server` paths of llamafile_tpu/cli.py.
Both read the one flag table of utils/flags.py and run on the card unless
`--device cpu` is given. `--cli` carries the penalty window and mirostat
through Engine.generate's decode, and `--prompt-cache` reuses and saves
the prompt's KV state (runtime/state.py). The chat REPL, --tokenize and
--version are not ported yet and exit with an error.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

_UNPORTED_MODES = ("chat", "tokenize", "version")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for mode in _UNPORTED_MODES:
        if f"--{mode}" in argv:
            print(f"error: --{mode} is not yet ported to llamafile_tpu_torch "
                  "(use --cli)", file=sys.stderr)
            return 2
    from .utils.flags import parse_flags
    flags = parse_flags(argv)
    if not flags.model:
        print("error: --model required", file=sys.stderr)
        return 1
    if "--server" in argv:
        from .server.http import serve
        return serve(flags)
    from .runtime.engine import load_engine
    t0 = time.time()
    try:
        eng = load_engine(flags.model, device=flags.device,
                          max_seq_len=flags.ctx_size, kv_dtype=flags.kv_dtype)
        print(f"loaded {flags.model}: {eng.cfg.n_layers}L d{eng.cfg.d_model} "
              f"vocab {eng.cfg.n_vocab} on {eng.device} in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
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


if __name__ == "__main__":
    sys.exit(main())
