"""Export a model for the native C++ runner (``dllama_tpu_torch/native/``).

The counterpart of the JAX package's ``export_native``: three programs of
the dense Llama forward (``llama.forward_traced``), each traced by
``torch.export`` and compiled by AOTInductor into a ``.pt2`` package the
runner loads with libtorch's ``AOTIModelPackageLoader``:

* ``model.pt2`` — one decode step: (weights..., k_cache, v_cache, token
  i32[1], pos i32[]) -> logits f32[vocab];
* ``model_loop.pt2`` — ``LOOP_STEPS`` decode steps sampled on the device,
  one ``while_loop`` whose carry holds the caches: (..., temperature f32[],
  topp f32[], seed i32[]) -> tokens i32[LOOP_STEPS]. The noise is
  ``sampler.hash_gumbel`` of (seed, step), not ``jax.random``'s stream;
* ``model_prefill.pt2`` — a ``PREFILL_BUCKET``-token prompt step with its
  real count n: (..., tokens i32[bucket], pos i32[], n i32[]) -> the
  logits of row n - 1.

Every program updates the caches in place. The weights are program inputs,
in the order of the JAX package's flattened ``{"params", "rope"}`` tree
(sorted keys), so one ``weights.bin`` serves the three, with the same bytes
as the JAX exporter's for the same f32 params. Beside them: the exported
programs (``torch.export.save``; run them with ``torch.export.load(path)
.module()``), ``manifest.txt`` (the JAX manifest's record grammar under
the header ``dllama_native_torch 1``) and a copy of the tokenizer.

Usage:
    python -m dllama_tpu_torch.export_native --model m.m --tokenizer t.t --out dir/
        [--dtype float32|bfloat16] [--cache-dtype float32|bfloat16|f8]
        [--no-aot] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import shutil
import time

import torch

from dllama_tpu_torch import resolve_device

#: decode steps fused into one program of the runner's chunked loop
LOOP_STEPS = 32

#: prompt positions one prefill dispatch consumes (clamped to seq_len)
PREFILL_BUCKET = 64

#: the program files: (exported program, AOTInductor package, manifest key)
PROGRAMS = {
    "step": ("model_export.pt2", "model.pt2", "package_file"),
    "loop": ("model_loop_export.pt2", "model_loop.pt2", "loop_package_file"),
    "prefill": ("model_prefill_export.pt2", "model_prefill.pt2", "prefill_package_file"),
}

#: AOTInductor settings of the compiles: the packages' C++ wrapper is built
#: by the g++ the runner is built by, not whatever $CXX names (Inductor's
#: default); no buffer is reused by name (torch 2.11's peak-memory estimate
#: of the reuse plan fails inside the loop's body)
INDUCTOR_CONFIGS = {"cpp.cxx": ("g++",), "allow_buffer_reuse": False}

_DTYPE_NAMES = {
    torch.float32: "f32",
    torch.bfloat16: "bf16",
    torch.float16: "f16",
    torch.float8_e4m3fn: "f8e4m3fn",
    torch.int32: "i32",
}


def flatten_weights(params: dict, rope: dict) -> tuple:
    """(names, leaves) of ``{"params": params, "rope": rope}`` in the order
    ``jax.tree_util`` flattens a dict tree (keys sorted at every level), each
    name the dotted path, as the JAX exporter names its leaves."""
    names, leaves = [], []

    def walk(prefix, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}.{key}" if prefix else key, node[key])
        else:
            names.append(prefix)
            leaves.append(node)

    walk("", {"params": params, "rope": rope})
    return names, leaves


def unflatten_weights(names: list, leaves) -> tuple:
    """(params, rope) back from :func:`flatten_weights`'s lists."""
    tree: dict = {}
    for name, leaf in zip(names, leaves):
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree["params"], tree["rope"]


class _Program(torch.nn.Module):
    """A program's module: the flat weight leaves first, then the caches
    and the program's own inputs."""

    def __init__(self, cfg, names: list):
        super().__init__()
        self.cfg, self.names = cfg, list(names)

    def split(self, args: tuple) -> tuple:
        n = len(self.names)
        params, rope = unflatten_weights(self.names, args[:n])
        return params, rope, args[n:]


class StepProgram(_Program):
    def forward(self, *args):
        from dllama_tpu_torch.models import llama

        params, rope, (k, v, token, pos) = self.split(args)
        logits, _ = llama.forward_traced(self.cfg, params, rope, token, {"k": k, "v": v}, pos)
        return logits[0]


class PrefillProgram(_Program):
    def forward(self, *args):
        from dllama_tpu_torch.models import llama

        params, rope, (k, v, tokens, pos, n) = self.split(args)
        logits, _ = llama.forward_traced(self.cfg, params, rope, tokens, {"k": k, "v": v}, pos,
                                         last=n - 1)
        return logits[0]


class LoopProgram(_Program):
    def forward(self, *args):
        from torch._higher_order_ops.while_loop import while_loop

        from dllama_tpu_torch.models import llama
        from dllama_tpu_torch.runtime.sampler import sample_traced

        cfg = self.cfg
        params, rope, (k, v, token, pos, temp, topp, seed) = self.split(args)

        def cond(i, k_c, v_c, tok, p, out):
            return i < LOOP_STEPS

        def body(i, k_c, v_c, tok, p, out):
            # a loop body must not mutate its carry: the forward writes new
            # caches, and the program copies the last ones in after the loop
            logits, new = llama.forward_traced(cfg, params, rope, tok, {"k": k_c, "v": v_c}, p,
                                               in_place=False)
            nxt = sample_traced(logits[0], temp, topp, seed, i).to(torch.int32)
            out = out.index_copy(0, i.reshape(1).long(), nxt)
            return i + 1, new["k"], new["v"], nxt, p + 1, out

        i0 = torch.zeros((), dtype=torch.int32, device=token.device)
        out0 = torch.zeros(LOOP_STEPS, dtype=torch.int32, device=token.device)
        _, k_end, v_end, _, _, out = while_loop(cond, body,
                                                (i0, k.clone(), v.clone(), token, pos, out0))
        k.copy_(k_end)
        v.copy_(v_end)
        return out


def example_inputs(cache: dict, device, bucket: int) -> dict:
    """Each program's inputs after the weights, as the exporter traces
    them."""
    def i32(*v, shape=None):
        t = torch.tensor(v, dtype=torch.int32, device=device)
        return t.reshape(shape) if shape is not None else t

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    k, v = cache["k"], cache["v"]
    return {
        "step": [k, v, i32(0), i32(0, shape=())],
        "loop": [k, v, i32(0), i32(0, shape=()), f32(0.8), f32(0.9), i32(1, shape=())],
        "prefill": [k, v, torch.zeros(bucket, dtype=torch.int32, device=device),
                    i32(0, shape=()), i32(1, shape=())],
    }


def _check_exportable(cfg, params: dict) -> None:
    from dllama_tpu_torch.models import llama

    if cfg.is_moe:
        raise ValueError(f"export_model exports dense Llama models; arch {cfg.arch!r} (MoE) "
                         "is not exported yet")
    if llama.has_quant_leaves(params):
        raise ValueError("export_model takes dense params: load the model with --dtype "
                         "float32 or bfloat16 (quantized leaves are not exported yet)")


def export_model(cfg, params: dict, out_dir: str, *, tokenizer_path: str | None = None,
                 cache_dtype=torch.bfloat16, model_name: str = "llama", aot: bool = True,
                 device=None, times: dict | None = None) -> str:
    """Export the three programs of ``cfg``'s dense Llama with ``params``
    into ``out_dir`` (see the module docstring), compiled by AOTInductor for
    ``device`` (the card unless asked otherwise) unless ``aot`` is False.
    ``times``, if given, receives each stage's seconds (``export_step``,
    ``compile_step``, ...). A failed export or compile raises. Returns
    ``out_dir``."""
    from dllama_tpu_torch.models import llama

    _check_exportable(cfg, params)
    device = resolve_device(device)
    times = {} if times is None else times
    os.makedirs(out_dir, exist_ok=True)
    params = llama.params_to(params, device)
    names, leaves = flatten_weights(params, llama.rope_tables(cfg, device))
    cache = llama.init_cache(cfg, cache_dtype, device)
    bucket = min(PREFILL_BUCKET, cfg.seq_len)
    extra = example_inputs(cache, device, bucket)
    modules = {"step": StepProgram, "loop": LoopProgram, "prefill": PrefillProgram}

    programs = {}
    for what, cls in modules.items():
        t0 = time.perf_counter()
        ep = programs[what] = torch.export.export(cls(cfg, names), tuple(leaves + extra[what]),
                                                  strict=False)
        # saved without its example inputs: they are the weights, which
        # weights.bin holds once (AOTInductor still needs them, after)
        examples, ep.example_inputs = ep.example_inputs, None
        torch.export.save(ep, os.path.join(out_dir, PROGRAMS[what][0]))
        ep.example_inputs = examples
        times[f"export_{what}"] = time.perf_counter() - t0
        print(f"📦 exported the {what} program in {times[f'export_{what}']:.1f} s")
    if aot:
        for what, ep in programs.items():
            t0 = time.perf_counter()
            torch._inductor.aoti_compile_and_package(
                ep, package_path=os.path.join(out_dir, PROGRAMS[what][1]),
                inductor_configs=INDUCTOR_CONFIGS)
            times[f"compile_{what}"] = time.perf_counter() - t0
            print(f"🛠️  compiled the {what} program in {times[f'compile_{what}']:.1f} s")

    lines = [
        "dllama_native_torch 1",
        "# every program updates the caches in place and returns one output",
        f"model {model_name}",
        f"vocab_size {cfg.vocab_size}",
        f"seq_len {cfg.seq_len}",
        f"device {device.type}",
        "weights_file weights.bin",
    ]
    for what, (exported, package, key) in PROGRAMS.items():
        lines.append(f"{what}_export_file {exported}")
        if aot:
            lines.append(f"{key} {package}")
    lines += [f"loop_steps {LOOP_STEPS}", f"prefill_bucket {bucket}"]

    def dims(shape) -> str:
        return " ".join([str(len(shape))] + [str(d) for d in shape])

    offset = 0
    with open(os.path.join(out_dir, "weights.bin"), "wb") as f:
        for name, leaf in zip(names, leaves):
            data = leaf.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
            lines.append(f"input {name} weight {_DTYPE_NAMES[leaf.dtype]} {offset} {len(data)} "
                         f"{dims(leaf.shape)}")
            f.write(data)
            offset += len(data)
    for name in ("k", "v"):
        c = cache[name]
        lines.append(f"input cache.{name} cache {_DTYPE_NAMES[c.dtype]} -1 "
                     f"{c.numel() * c.element_size()} {dims(c.shape)}")
    lines.append("input token token i32 -1 4 1 1")
    lines.append("input pos pos i32 -1 4 0")
    lines.append(f"output logits logits f32 1 {cfg.vocab_size}")
    with open(os.path.join(out_dir, "manifest.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if tokenizer_path:
        shutil.copy(tokenizer_path, os.path.join(out_dir, "tokenizer.t"))
    return out_dir


def main(argv=None) -> int:
    import argparse
    import sys

    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig, resolve_dtype

    p = argparse.ArgumentParser(prog="dllama_tpu_torch.export_native")
    p.add_argument("--model", required=True, help=".m weight file")
    p.add_argument("--tokenizer", default=None, help=".t tokenizer file")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument(
        "--cache-dtype", default="bfloat16", choices=["float32", "bfloat16", "f8"],
        help="KV cache element type of the exported programs (f8 = float8_e4m3fn)")
    p.add_argument("--no-aot", action="store_true",
                   help="write the exported programs and the manifest, compile no package")
    p.add_argument("--device", default=None,
                   help="device the programs run on (default: cuda; 'cpu' when asked)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel export: not in the port yet (exits non-zero)")
    args = p.parse_args(argv)
    if args.tp > 1:
        sys.stderr.write("--tp > 1: the port's tensor-parallel export is still to come; "
                         "export with --tp 1\n")
        return 2

    device = resolve_device(args.device)
    with WeightFileReader(args.model) as reader:
        cfg = ModelConfig.from_spec(reader.spec, dtype=args.dtype)
        if cfg.is_moe:  # refuse before reading the expert stacks
            _check_exportable(cfg, {})
        params = llama.params_from_reader(reader, cfg, device)
    export_model(cfg, params, args.out, tokenizer_path=args.tokenizer,
                 cache_dtype=resolve_dtype(args.cache_dtype, default="bfloat16"),
                 aot=not args.no_aot, device=device)
    print(f"📦 exported to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
