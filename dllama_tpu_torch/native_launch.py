"""Build the native C++ runner if it is missing or stale, then exec it.

The counterpart of the JAX package's ``native_launch``: the runner
(``native/src/main.cc``) is built at first use into
``dllama_tpu_torch/native/build/`` with ``g++ -std=c++17`` against the
installed wheel's libtorch (its include and library paths from
``torch.utils.cpp_extension``, ``-ltorch_cuda -lc10_cuda`` when the wheel
has CUDA, an rpath to ``torch/lib``), then this process is replaced by it.
A failed build raises; the runner's own failure is its exit code. Nothing
falls back to Python.

Usage:
    python -m dllama_tpu_torch.native_launch generate --export-dir dir/ [--prompt ...]
        [--steps N] [--temperature F] [--topp F] [--seed N]
"""

from __future__ import annotations

import os
import subprocess
import sys

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
SRC = os.path.join(NATIVE, "src")
BUILD = os.path.join(NATIVE, "build")

RUNNER = "dllama-native-torch"

#: every binary and its sources; the runner alone links libtorch
TARGETS = {
    RUNNER: ("main.cc", "manifest.cc", "tokenizer.cc", "sampler.cc"),
    "tokenizer-test": ("tokenizer_test.cc", "tokenizer.cc"),
    "sampler-test": ("sampler_test.cc", "sampler.cc"),
    "manifest-test": ("manifest_test.cc", "manifest.cc"),
    "tokenizer-probe": ("tokenizer_probe.cc", "tokenizer.cc"),
}

#: the exit-code unit tests
UNIT_TESTS = ("tokenizer-test", "sampler-test", "manifest-test")


def torch_flags() -> list:
    """g++ flags that compile and link against the installed libtorch."""
    import torch
    from torch.utils import cpp_extension

    lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda is not None and os.path.exists(os.path.join(lib, "libtorch_cuda.so")):
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    abi = int(torch.compiled_with_cxx11_abi())
    return ([f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
            + [f"-I{p}" for p in cpp_extension.include_paths()]
            + [f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed"] + libs)


def command(target: str) -> list:
    """The g++ command line that builds ``target``."""
    sources = [os.path.join(SRC, s) for s in TARGETS[target]]
    out = os.path.join(BUILD, target)
    if target == RUNNER:
        # libtorch's headers warn under -Wall on some compilers: no -Werror
        return ["g++", "-std=c++17", "-O2", "-Wall", *sources, "-o", out, *torch_flags()]
    return ["g++", "-std=c++17", "-O2", "-Wall", "-Werror", *sources, "-o", out]


def _stamp(cmd: list) -> str:
    """What a binary was built by: the command and the installed torch."""
    import torch

    return f"torch {torch.__version__}\n{' '.join(cmd)}"


def _stale(target: str, cmd: list) -> bool:
    out = os.path.join(BUILD, target)
    stamp = out + ".cmd"
    if not (os.path.exists(out) and os.path.exists(stamp)):
        return True
    with open(stamp) as f:
        if f.read() != _stamp(cmd):
            return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(os.path.join(SRC, name)) > built for name in os.listdir(SRC))


def build(targets=None) -> dict:
    """Build each of ``targets`` (default: all) that is missing, older than a
    source, or made by another command or torch; the builds run in
    parallel. Returns {target: path}; a failed build raises with the
    compiler's output."""
    targets = list(TARGETS if targets is None else targets)
    os.makedirs(BUILD, exist_ok=True)
    cmds = {t: command(t) for t in targets}
    running = {t: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
               for t, cmd in cmds.items() if _stale(t, cmd)}
    failed = []
    for t, proc in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{t}: g++ exited {proc.returncode}\n{log}")
            continue
        with open(os.path.join(BUILD, t) + ".cmd", "w") as f:
            f.write(_stamp(cmds[t]))
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return {t: os.path.join(BUILD, t) for t in targets}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    binary = build([RUNNER])[RUNNER]
    os.execv(binary, [binary] + argv)


if __name__ == "__main__":
    raise SystemExit(main())
