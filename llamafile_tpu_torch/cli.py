"""Command line of the port: raw completion and the HTTP server.

  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." -n 32
  python -m llamafile_tpu_torch.cli --model m.gguf --cli -p "..." --device cpu
      [--kv-dtype bf16|int8]
  python -m llamafile_tpu_torch.cli --server -m m.gguf --slots 8 \
      --listen 127.0.0.1:8080 [--ctx-size N] [--kv-dtype bf16|int8] \
      [--preempt SECONDS] [--device cpu] [--temp ... sampling defaults]

Counterpart of the `--cli` and `--server` paths of llamafile_tpu/cli.py.
Both run on the card unless `--device cpu` is given. The chat REPL,
--tokenize and --version are not ported yet and exit with an error.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

_UNPORTED_MODES = ("chat", "tokenize", "version")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llamafile-tpu-torch")
    p.add_argument("--cli", action="store_true", help="raw completion (default)")
    p.add_argument("-m", "--model")
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-n", "--n-predict", type=int, dest="n_predict", default=-1)
    p.add_argument("-c", "--ctx-size", type=int, dest="ctx_size", default=8192)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--kv-dtype", dest="kv_dtype", choices=["bf16", "int8"],
                   default="bf16")
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-k", type=int, dest="top_k", default=40)
    p.add_argument("--top-p", type=float, dest="top_p", default=0.95)
    p.add_argument("--min-p", type=float, dest="min_p", default=0.05)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--repeat-penalty", type=float, dest="repeat_penalty", default=1.0)
    p.add_argument("--repeat-last-n", type=int, dest="repeat_last_n", default=64)
    p.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--tfs", type=float, dest="tfs_z", default=1.0)
    p.add_argument("--typical", type=float, dest="typical_p", default=1.0)
    p.add_argument("--dynatemp-range", type=float, dest="dynatemp_range", default=0.0)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for mode in _UNPORTED_MODES:
        if f"--{mode}" in argv:
            print(f"error: --{mode} is not yet ported to llamafile_tpu_torch "
                  "(use --cli)", file=sys.stderr)
            return 2
    if "--server" in argv:
        from .utils.flags import parse_flags
        flags = parse_flags(argv)
        if not flags.model:
            print("error: --model required", file=sys.stderr)
            return 1
        from .server.http import serve
        return serve(flags)
    args = _parser().parse_args(argv)
    if not args.model:
        print("error: --model required", file=sys.stderr)
        return 1
    from .runtime.engine import load_engine
    from .runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=args.temp, top_k=args.top_k,
                        top_p=args.top_p, min_p=args.min_p, seed=args.seed,
                        repeat_penalty=args.repeat_penalty,
                        penalty_last_n=args.repeat_last_n,
                        mirostat=args.mirostat, tfs_z=args.tfs_z,
                        typical_p=args.typical_p,
                        dynatemp_range=args.dynatemp_range)
    t0 = time.time()
    try:
        eng = load_engine(args.model, device=args.device,
                          max_seq_len=args.ctx_size, kv_dtype=args.kv_dtype)
        print(f"loaded {args.model}: {eng.cfg.n_layers}L d{eng.cfg.d_model} "
              f"vocab {eng.cfg.n_vocab} on {eng.device} in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
        n = args.n_predict if args.n_predict > 0 else 128
        t0 = time.time()
        count = 0
        for _tid, piece in eng.generate(args.prompt, max_tokens=n, sampling=sp):
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
