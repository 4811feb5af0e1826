"""dllama_tpu_torch — the PyTorch/CUDA port of dllama_tpu for one NVIDIA H100.

Same modules, same names, same numerics as the JAX package, written in
PyTorch's idiom: plain functions on tensors, an explicit ``device`` at every
entry point, explicit ``torch.Generator``s, and in-place KV-cache writes where
JAX donates the buffer. Every Pallas kernel of the JAX package and of its Q40
kernel experiments has a hand-written CUDA counterpart under ``csrc/`` (built
and bound by ``kernels``); each sits beside a plain PyTorch version of the same function,
which runs only for CPU tensors.

Nothing here imports ``jax`` or ``dllama_tpu``: the jax-free pieces the port
needs (formats, block codecs, tokenizer) are copies. The fleet's control
plane (``serving.{evloop,router,autoscale,fleet}``, ``obsv.forensics`` and
the CLI modes ``router``, ``fleet``, ``top``, ``explain`` and ``snapshot``)
imports no ``torch`` either.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises when CUDA is wanted and absent — never a quiet CPU run."""
    import torch  # here, not at the top: the fleet's control plane imports
    #               this package and must never load torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
