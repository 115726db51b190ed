"""Chat template application — template-sniffing like llama_chat_apply_template.

The port's own copy of llamafile_tpu/runtime/chat.py (pure Python).

The reference (upstream llama.cpp, used by llamafiler's v1_chat_completions.cpp:537)
does not run Jinja; it sniffs the GGUF's tokenizer.chat_template string for known
dialects and formats messages with hand-rolled writers. We reproduce that scheme
for the common dialects (chatml, llama2, llama3, mistral, gemma, phi3, zephyr,
tinyllama/zephyr variant), defaulting to chatml.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def detect_dialect(template: Optional[str]) -> str:
    t = template or ""
    if "<|im_start|>" in t:
        return "chatml"
    if "<|start_header_id|>" in t:
        return "llama3"
    if "[INST]" in t and "[/INST]" in t:
        return "mistral" if "<<SYS>>" not in t else "llama2"
    if "<start_of_turn>" in t:
        return "gemma"
    if "<|assistant|>" in t and "<|end|>" in t:
        return "phi3"
    if "<|user|>" in t or "<|system|>" in t:
        return "zephyr"
    return "chatml"


def render_jinja(template: str, messages: List[Dict[str, str]],
                 add_assistant: bool = True) -> Optional[str]:
    """Render the GGUF's jinja chat template exactly (HF semantics).

    The reference sniffs dialects instead of running jinja; we do both —
    jinja when it renders cleanly (exact parity with HF), sniffing fallback.
    """
    try:
        import jinja2
        env = jinja2.sandbox.ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
            ValueError(msg))
        tpl = env.from_string(template)
        return tpl.render(messages=messages, add_generation_prompt=add_assistant,
                          bos_token="", eos_token="")
    except Exception:
        return None


def apply_chat_template(messages: List[Dict[str, str]],
                        template: Optional[str] = None,
                        add_assistant: bool = True,
                        dialect: Optional[str] = None) -> str:
    """messages: [{role, content}] -> prompt string (model-specific framing)."""
    if dialect is None and template and "{%" in template:
        out = render_jinja(template, messages, add_assistant)
        if out:
            return out
    d = dialect or detect_dialect(template)
    out = []
    if d == "llama3":
        for m in messages:
            out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                       f"{m['content']}<|eot_id|>")
        if add_assistant:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    if d in ("llama2", "mistral"):
        system = ""
        msgs = list(messages)
        if msgs and msgs[0]["role"] == "system":
            system = msgs.pop(0)["content"]
        for i in range(0, len(msgs), 2):
            user = msgs[i]["content"]
            if d == "llama2" and system and i == 0:
                user = f"<<SYS>>\n{system}\n<</SYS>>\n\n{user}"
            elif system and i == 0:
                user = f"{system}\n\n{user}"
            out.append(f"[INST] {user} [/INST]")
            if i + 1 < len(msgs):
                out.append(f" {msgs[i + 1]['content']}</s>")
        return "".join(out)
    if d == "gemma":
        for m in messages:
            role = "model" if m["role"] == "assistant" else m["role"]
            out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
        if add_assistant:
            out.append("<start_of_turn>model\n")
        return "".join(out)
    if d == "phi3":
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m['content']}<|end|>\n")
        if add_assistant:
            out.append("<|assistant|>\n")
        return "".join(out)
    if d == "zephyr":
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m['content']}</s>\n")
        if add_assistant:
            out.append("<|assistant|>\n")
        return "".join(out)
    # chatml default
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_assistant:
        out.append("<|im_start|>assistant\n")
    return "".join(out)
