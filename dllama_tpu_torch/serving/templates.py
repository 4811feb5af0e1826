"""Chat prompt templates.

* ``llama2``: the `[INST] <<SYS>>` schema the reference chat CLI renders
  (`distributed-llama/src/apps/dllama/dllama.cpp:136-142`).
* ``llama3``: the header-id schema the reference API server renders
  (`distributed-llama/src/apps/dllama-api/dllama-api.cpp:173-181`).
"""

from __future__ import annotations


def render_llama2_turn(user: str, system: str = "", first_turn: bool = False) -> str:
    if first_turn and system:
        return f"[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{user} [/INST]"
    return f"[INST] {user} [/INST]"


def render_llama3_chat(messages: list) -> str:
    """messages: list of {"role": str, "content": str}. Appends the assistant header."""
    out = []
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>")
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


TEMPLATES = {"llama2": render_llama2_turn, "llama3": render_llama3_chat}
