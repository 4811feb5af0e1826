"""``python -m dllama_tpu_torch.cli fleet`` end to end on the CPU: two port
``serve`` replicas (``--replica-arg "--device cpu ..."``) behind the
router, the control-plane modes on the live fleet, and the drain.

The fleet answers a chat through its front door (and a repeat of it, which
affinity routes), ``/stats`` shows both replicas; ``cli router`` fronts the
same replicas as a second door; ``cli top --iterations 1`` draws one frame
with a row per replica, ``cli snapshot`` writes a tarball of the fleet's
documents and trace parts, and after SIGTERM (exit 0) ``cli explain``
joins the request's router and replica spans from the merged
``DLLAMA_TRACE`` file.
"""

import json
import os
import signal
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest

from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.quants import blocks
from tests.test_router import free_port, request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "dllama_tpu_torch.cli"]


@pytest.fixture(scope="module")
def fleet_model(tmp_path_factory):
    """The tiny Q40 model and byte tokenizer of the JAX fleet smoke."""
    d = tmp_path_factory.mktemp("torch_fleet")
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=300, seq_len=96, weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    write_model(str(d / "m.m"), spec,
                {e.name: 0.05 * rng.standard_normal(e.d * e.n).astype(np.float32)
                 for e in tensor_plan(spec)})
    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b"hi"] * 41
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=[0.0] * 300,
                                                  bos_id=1, eos_id=2))
    return str(d / "m.m"), str(d / "t.t")


def _cli(args, env, timeout=60):
    return subprocess.run(CLI + args, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def _wait_ready(port, proc, seconds=120):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        try:
            if request(port, "GET", "/ready", timeout=2)[0] == 200:
                return
        except OSError:
            pass  # not listening yet
        time.sleep(0.2)
    raise AssertionError("front door never became ready")


def test_fleet_of_two_serves_and_the_control_plane_modes_see_it(fleet_model, tmp_path):
    model, tok = fleet_model
    (tmp_path / "trace").mkdir()
    trace = str(tmp_path / "trace" / "trace.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    router_port, door2, base_port = free_port(), free_port(), free_port() + 1000
    proc = subprocess.Popen(
        CLI + ["fleet", "--model", model, "--tokenizer", tok, "--replicas", "2",
               "--base-port", str(base_port), "--host", "127.0.0.1", "--port", str(router_port),
               "--probe-interval", "0.3", "--ready-timeout", "120",
               "--log-dir", str(tmp_path / "logs"),
               "--replica-arg", "--device cpu --dtype float32 --batch-window 5 --batch-max 2"],
        env=dict(env, DLLAMA_TRACE=trace), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    router = None
    try:
        _wait_ready(router_port, proc)
        body = {"model": "m", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4, "temperature": 0}
        code, raw, headers = request(router_port, "POST", "/v1/chat/completions", body,
                                     headers={"X-Request-Id": "req-fleet-e2e"}, timeout=120)
        assert code == 200, raw[:500]
        first = json.loads(raw)["choices"][0]["message"]
        assert first["role"] == "assistant" and headers["X-Request-Id"] == "req-fleet-e2e"
        code, raw, _ = request(router_port, "POST", "/v1/chat/completions", body, timeout=120)
        assert code == 200 and json.loads(raw)["choices"][0]["message"] == first  # greedy

        stats = json.loads(request(router_port, "GET", "/stats", timeout=10)[1])
        assert stats["load"]["replicas_ready"] == 2
        assert stats["load"]["fleet"]["slots_total"] == 4  # 2 x batch-max 2
        replicas = [r["name"] for r in stats["load"]["replicas"]]

        # a standalone front door over the same replicas
        router = subprocess.Popen(
            CLI + ["router", "--host", "127.0.0.1", "--port", str(door2), "--probe-interval", "0.3"]
            + [a for name in replicas for a in ("--replica", name)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _wait_ready(door2, router, seconds=30)
        code, raw, _ = request(door2, "POST", "/v1/chat/completions", body, timeout=120)
        assert code == 200 and json.loads(raw)["choices"][0]["message"] == first

        top = _cli(["top", "--router", f"127.0.0.1:{router_port}", "--iterations", "1"], env)
        assert top.returncode == 0, top.stdout + top.stderr
        assert all(name in top.stdout for name in replicas) and "2/2 ready" in top.stdout

        bundle = str(tmp_path / "snap.tar.gz")
        snap = _cli(["snapshot", "--router", f"127.0.0.1:{router_port}", "--out", bundle,
                     "--trace-dir", str(tmp_path / "trace")], env)
        assert snap.returncode == 0, snap.stdout + snap.stderr
        with tarfile.open(bundle) as tar:
            names = tar.getnames()
        assert "router/metrics" in names and "router/stats" in names
        assert all(f"{name.replace(':', '-')}/metrics" in names for name in replicas)

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0
    finally:
        for p in (router, proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    explain = _cli(["explain", "req-fleet-e2e", "--trace", trace, "--json"], env)
    assert explain.returncode == 0, explain.stdout + explain.stderr
    wf = json.loads(explain.stdout)
    phases = {(r["source"], r["phase"]) for r in wf["rows"]}
    assert {("router", "router_proxy"), ("replica", "request"), ("replica", "decode")} <= phases
    assert wf["hops"] and wf["hops"][0]["status"] == 200 and wf["wall_ms"] > 0
    text = _cli(["explain", "req-fleet-e2e", "--trace", trace], env)
    assert text.returncode == 0 and "req-fleet-e2e" in text.stdout
