"""The port's multi-host tensor-parallel bootstrap on the CPU: the mirror of
``tests/test_multihost.py``.

* Two OS processes join one gloo world through the CLI's ``--coordinator
  / --num-hosts / --host-id`` (``cli.tp_plan``) and run a real gather.
* ``cli worker --device cpu --tp 4`` on two "hosts" (two OS processes, each
  this host's first rank plus one spawned local rank: rank = host·2 +
  local index) prints host 0's tokens, equal to a one-process ``cli
  generate``; host 1 keeps its output back.
* ``cli.tp_plan`` refuses what this slice leaves out, and a ``--tp``
  beyond the visible GPUs, with the reason.
"""

import argparse
import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu_torch import cli
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.quants import blocks

ROOT = Path(__file__).resolve().parent.parent

CHILD = textwrap.dedent(
    """
    import sys
    import torch
    from dllama_tpu_torch.cli import build_parser, tp_plan
    from dllama_tpu_torch.parallel.collectives import gather_columns
    from dllama_tpu_torch.parallel.group import close_tp, init_tp

    args = build_parser().parse_args(sys.argv[1:])
    plan = tp_plan(args, 0)
    rank = plan["ranks"][0]
    assert list(plan["ranks"]) == [args.host_id] and plan["backend"] == "gloo", plan
    group = init_tp(rank, plan["size"], backend=plan["backend"], device=plan["devices"][0],
                    init_method=plan["init_method"])
    out = gather_columns(torch.full((1, 32), float(rank + 1)), group)
    assert out.shape == (1, 64) and out[0, ::32].tolist() == [1.0, 2.0], out
    assert group.sent_bytes == 32 * 4
    close_tp()
    print(f"HOST {rank} OK", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_hosts(argvs: list, timeout: float = 240) -> list:
    procs = [subprocess.Popen(a, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env()) for a in argvs]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host run deadlocked")
        outs.append((p.returncode, out, err))
    return outs


def test_two_processes_join_through_the_cli_flags_and_gather(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    port = _free_port()
    outs = _run_hosts([
        [sys.executable, str(child), "generate", "--model", "unused.m", "--tokenizer",
         "unused.t", "--device", "cpu", "--tp", "2", "--coordinator", f"127.0.0.1:{port}",
         "--num-hosts", "2", "--host-id", str(h)] for h in (0, 1)])
    for h, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"host {h} failed:\n{err[-3000:]}\n{out}"
        assert f"HOST {h} OK" in out


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [b" ", b"He", b"ll", b"o", b" w", b"or", b"ld", b"Hello", b" world"]
    vocab += [f"tok{i}".encode() for i in range(320 - len(vocab))]
    scores = [0.0] * 259 + [float(i) for i in range(len(vocab) - 259)]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=4, vocab_size=len(vocab), seq_len=64,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    tensors = {e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                        else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
               for e in tensor_plan(spec)}
    write_model(str(d / "m.m"), spec, tensors)
    return d / "m.m", d / "t.t"


def _token_ids(stdout: str) -> list:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("Token ids:"))
    return [int(t) for t in line.split(":", 1)[1].split()]


def test_worker_mode_on_two_hosts_prints_the_one_process_tokens(model_files):
    model, tok = model_files
    common = [sys.executable, "-m", "dllama_tpu_torch.cli"]
    flags = ["--device", "cpu", "--model", str(model), "--tokenizer", str(tok), "--prompt",
             "Hello world", "--steps", "10", "--temperature", "0", "--seed", "0", "--dtype",
             "float32", "--weights-float-type", "q40"]
    port = _free_port()
    hosts = [common + ["worker", *flags, "--tp", "4", "--coordinator", f"127.0.0.1:{port}",
                       "--num-hosts", "2", "--host-id", str(h)] for h in (0, 1)]
    one = common + ["generate", *flags]
    (rc0, out0, err0), (rc1, out1, err1), (rc, out, err) = _run_hosts([*hosts, one])
    assert rc0 == 0 and rc1 == 0 and rc == 0, (err0[-2000:], err1[-2000:], err[-2000:])
    assert _token_ids(out0) == _token_ids(out)
    assert "🔗 tensor-parallel over 4 devices (gloo, plain wire" in out0
    assert "Token ids" not in out1 and not out1.strip()  # host 1 keeps its output back


def _args(**kw) -> argparse.Namespace:
    base = dict(mode="generate", tp=1, device=None, tp_overlap=False, tp_reduce="off",
                coordinator=None, num_hosts=None, host_id=None, spec_draft=0)
    return argparse.Namespace(**{**base, **kw})


def test_tp_plan_layout():
    assert cli.tp_plan(_args(), 0) is None
    plan = cli.tp_plan(_args(tp=4), 4)
    assert plan["size"] == 4 and list(plan["ranks"]) == [0, 1, 2, 3]
    assert plan["backend"] == "nccl" and plan["devices"] == [f"cuda:{i}" for i in range(4)]
    plan = cli.tp_plan(_args(tp=0, coordinator="h0:29500", num_hosts=2, host_id=1), 4)
    assert plan["size"] == 8 and list(plan["ranks"]) == [4, 5, 6, 7]
    assert plan["init_method"] == "tcp://h0:29500"
    plan = cli.tp_plan(_args(tp=2, device="cpu"), 0)
    assert plan["backend"] == "gloo" and plan["devices"] == ["cpu", "cpu"]


@pytest.mark.parametrize("kw,gpus,why", [
    (dict(tp=4), 2, "needs 4 GPUs on this host and 2 are visible"),
    (dict(tp=2, tp_overlap=True), 2, "--tp-overlap is not ported yet"),
    (dict(tp=2, tp_reduce="q80"), 2, "--tp-reduce q80 is not ported yet"),
    (dict(tp=2, mode="chat"), 2, "chat under --tp 2 needs a control plane"),
    (dict(tp=2, mode="serve"), 2, "serve under --tp 2"),
    (dict(tp=2, spec_draft=8), 2, "--spec-draft under --tp 2"),
    (dict(mode="worker"), 1, "worker mode requires --coordinator"),
    (dict(tp=3, coordinator="h:1", num_hosts=2, host_id=0), 4, "does not split evenly"),
    (dict(tp=2, coordinator="h:1"), 2, "requires --num-hosts and --host-id"),
], ids=["too_few_gpus", "overlap", "reduce", "chat", "serve", "spec", "worker_alone",
        "uneven_hosts", "coordinator_alone"])
def test_tp_plan_refuses_with_the_reason(kw, gpus, why):
    with pytest.raises(SystemExit, match=re.escape(why)):
        cli.tp_plan(_args(**kw), gpus)
