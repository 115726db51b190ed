"""Global flag table + CLI parsing.

Analog of llamafile's single flag table (reference: llamafile/llamafile.h:9-66,
flags.cpp:140 `llamafile_get_flags`; defaults flags.cpp:39-89). Same two-tier
config: embedded defaults (a `.args` file next to the model, mirroring
/zip/.args `cosmo_args`) overridden by command-line flags.

The port's own copy of llamafile_tpu/utils/flags.py, with the port's
`--device` (`cuda` by default, `cpu` on request) and `--kv-dtype` limited to
what the port runs (bf16, or int8 pages in the server's paged pool).
"""
from __future__ import annotations

import argparse
import os
import shlex
from dataclasses import dataclass, field, fields
from typing import List, Optional


@dataclass
class Flags:
    model: Optional[str] = None
    ctx_size: int = 8192
    batch_size: int = 256
    slots: int = 1
    state_dir: str = ""           # enables /slots/{id}?action=save|restore
    preempt: float = -1.0         # secs a request may queue before the
                                  # oldest active stream is preempted (<0 off)
    prompt_cache: str = ""        # CLI: session file (main.cpp --prompt-cache)
    listen: str = "127.0.0.1:8080"
    url_prefix: str = ""
    www_root: Optional[str] = None
    db: Optional[str] = None
    trust: List[str] = field(default_factory=list)
    token_burst: int = 100
    token_rate: int = 1
    token_cidr: int = 24
    temp: float = 0.8
    top_p: float = 0.95
    top_k: int = 40
    min_p: float = 0.05
    tfs_z: float = 1.0              # tail-free sampling (1.0 = off)
    typical_p: float = 1.0          # locally-typical sampling (1.0 = off)
    dynatemp_range: float = 0.0     # entropy-dynamic temperature (0 = off)
    dynatemp_exponent: float = 1.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repeat_last_n: int = 64         # penalty window (0 = off, -1 = whole ctx)
    seed: int = 0
    mirostat: int = 0               # 0=off 1=v1 2=v2 (reference default 0)
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    n_predict: int = -1
    prompt: Optional[str] = None
    reserve_tokens: int = -1        # default: 15% of ctx
    chat_template: Optional[str] = None
    verbose: bool = False
    trace: Optional[str] = None
    trap: bool = False
    mesh_dp: int = 1
    mesh_tp: int = 1
    # group-attention self-extend (reference --grp-attn-n/--grp-attn-w)
    grp_attn_n: int = 1
    grp_attn_w: int = 512
    kv_dtype: str = "bf16"
    device: str = "cuda"            # the port's device: cuda, or cpu on request
    mmproj: Optional[str] = None
    image: Optional[str] = None
    workers: int = 0                # 0 = ncpu + 4 (server I/O threads)
    # LoRA adapters (reference --lora/--lora-scaled/--lora-base): applied
    # as runtime low-rank side-matmuls (models/lora.py) — quantized base
    # stays unmerged, so --lora-base is unnecessary and ignored
    lora: List[str] = field(default_factory=list)
    lora_scaled: List[List[str]] = field(default_factory=list)
    lora_base: Optional[str] = None

    def sampling(self):
        from ..runtime.sampling import SamplingParams
        return SamplingParams(temperature=self.temp, top_k=self.top_k,
                              top_p=self.top_p, min_p=self.min_p,
                              tfs_z=self.tfs_z, typical_p=self.typical_p,
                              dynatemp_range=self.dynatemp_range,
                              dynatemp_exponent=self.dynatemp_exponent,
                              repeat_penalty=self.repeat_penalty,
                              presence_penalty=self.presence_penalty,
                              frequency_penalty=self.frequency_penalty,
                              penalty_last_n=self.repeat_last_n,
                              seed=self.seed,
                              mirostat=self.mirostat,
                              mirostat_tau=self.mirostat_tau,
                              mirostat_eta=self.mirostat_eta)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llamafile-tpu", add_help=True)
    p.add_argument("-m", "--model")
    p.add_argument("-c", "--ctx-size", type=int, dest="ctx_size", default=8192)
    p.add_argument("-b", "--batch-size", type=int, dest="batch_size", default=256)
    p.add_argument("--slots", type=int, default=1)
    p.add_argument("--state-dir", dest="state_dir", default="",
                   help="directory for /slots/{id} save/restore state files")
    p.add_argument("--preempt", type=float, default=-1.0,
                   help="preempt the oldest active stream after a request "
                        "queues this many seconds (reference worker.cpp "
                        "drop-oldest; <0 = queue forever)")
    p.add_argument("--prompt-cache", dest="prompt_cache", default="",
                   help="session file: reuse/save prompt KV across runs")
    p.add_argument("-l", "--listen", default="127.0.0.1:8080")
    p.add_argument("--url-prefix", dest="url_prefix", default="")
    p.add_argument("--www-root", dest="www_root")
    p.add_argument("--db")
    p.add_argument("--trust", action="append", default=[])
    p.add_argument("--token-burst", type=int, dest="token_burst", default=100)
    p.add_argument("--token-rate", type=int, dest="token_rate", default=1)
    p.add_argument("--token-cidr", type=int, dest="token_cidr", default=24)
    p.add_argument("--lora", action="append", default=[],
                   help="GGUF LoRA adapter (repeatable; runtime low-rank "
                        "application — quantized base stays exact)")
    p.add_argument("--lora-scaled", dest="lora_scaled", nargs=2,
                   action="append", default=[], metavar=("FNAME", "SCALE"))
    p.add_argument("--lora-base", dest="lora_base",
                   help="accepted for reference compatibility; unused "
                        "(adapters apply unmerged at runtime)")
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-p", type=float, dest="top_p", default=0.95)
    p.add_argument("--top-k", type=int, dest="top_k", default=40)
    p.add_argument("--min-p", type=float, dest="min_p", default=0.05)
    p.add_argument("--tfs", type=float, dest="tfs_z", default=1.0)
    p.add_argument("--typical", type=float, dest="typical_p", default=1.0)
    p.add_argument("--dynatemp-range", type=float, dest="dynatemp_range",
                   default=0.0)
    p.add_argument("--dynatemp-exp", type=float, dest="dynatemp_exponent",
                   default=1.0)
    p.add_argument("--repeat-penalty", type=float, dest="repeat_penalty",
                   default=1.0)
    p.add_argument("--presence-penalty", type=float, dest="presence_penalty",
                   default=0.0)
    p.add_argument("--frequency-penalty", type=float,
                   dest="frequency_penalty", default=0.0)
    p.add_argument("--repeat-last-n", type=int, dest="repeat_last_n",
                   default=64)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--mirostat-tau", type=float, dest="mirostat_tau",
                   default=5.0)
    p.add_argument("--mirostat-eta", type=float, dest="mirostat_eta",
                   default=0.1)
    p.add_argument("-n", "--n-predict", type=int, dest="n_predict", default=-1)
    p.add_argument("-p", "--prompt")
    p.add_argument("--reserve-tokens", type=int, dest="reserve_tokens", default=-1)
    p.add_argument("--chat-template", dest="chat_template")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--trace")
    p.add_argument("--trap", action="store_true")
    p.add_argument("--mesh-dp", type=int, dest="mesh_dp", default=1)
    p.add_argument("--mesh-tp", type=int, dest="mesh_tp", default=1)
    p.add_argument("--grp-attn-n", "-gan", type=int, dest="grp_attn_n",
                   default=1)
    p.add_argument("--grp-attn-w", "-gaw", type=int, dest="grp_attn_w",
                   default=512)
    p.add_argument("--kv-dtype", dest="kv_dtype", default="bf16",
                   choices=["bf16", "int8", "i8"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--mmproj")
    p.add_argument("--image", help="image file for llava multimodal prompts")
    p.add_argument("--workers", type=int, default=0)
    return p


def parse_flags(argv: List[str]) -> Flags:
    """Parse CLI args, honoring an `<model>.args` defaults file when present
    (the /zip/.args analog: default argv injected before user argv)."""
    pre: List[str] = []
    # find -m/--model early to locate a .args default file
    for i, a in enumerate(argv):
        if a in ("-m", "--model") and i + 1 < len(argv):
            args_file = argv[i + 1] + ".args"
            if os.path.exists(args_file):
                pre = shlex.split(open(args_file).read(), comments=True)
            break
    ns, _unknown = _build_parser().parse_known_args(pre + argv)
    fl = Flags()
    for f in fields(Flags):
        if hasattr(ns, f.name):
            setattr(fl, f.name, getattr(ns, f.name))
    return fl


FLAGS = Flags()  # process-global, like the reference's FLAG_* table
