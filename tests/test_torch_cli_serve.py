"""The port's CLI surface added with the server (CPU):

* ``cli serve --device cpu`` starts as a subprocess, answers ``POST
  /v1/chat/completions`` with the text the in-process port server gives,
  writes its pid file and drains on SIGTERM;
* ``serve`` refuses ``--kv-pages``, ``--role prefill|decode`` and batching
  with ``--kv-buckets 1`` before it loads the model;
* ``cli verify`` gives the JAX CLI's verdict and report on a good file and
  on copies with one byte flipped;
* ``--profile DIR`` writes a ``torch.profiler`` trace.
"""

import http.client
import json
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu import cli as jcli
from dllama_tpu.formats.spec import ArchType, ModelSpec
from dllama_tpu.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu.formats.weights import tensor_plan, write_model
from dllama_tpu.quants import blocks
from dllama_tpu_torch import cli as tcli

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_serve")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % b for b in range(256)]
    vocab += [b" ", b"e", b"t", b"he", b" the", b"hello", b" world"]
    scores = [0.0] * 259 + [-1.0, -2.0, -2.0, -1.5, -1.2, -1.1, -1.1]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=len(vocab), seq_len=256,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    write_model(str(d / "m.m"), spec, {
        e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                 else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
        for e in tensor_plan(spec)})
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _in_process_reply(files, body):
    """The same request through an in-process port server over the same files."""
    import threading

    from dllama_tpu_torch.serving import api_server

    args = tcli.build_parser().parse_args([
        "serve", "--model", str(files / "m.m"), "--tokenizer", str(files / "t.t"),
        "--device", "cpu", "--dtype", "float32", "--temperature", "0", "--seed", "1",
        "--chat-template", "llama3"])
    engine, tok, cfg = tcli.load_engine(args)
    state = api_server.ServerState(engine, tok, cfg, model_name="m.m", template="llama3",
                                   ts_interval=0.0)
    srv = api_server.create_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        return _post(srv.server_address[1], body)
    finally:
        srv.shutdown()
        srv.server_close()


def test_cli_serve_answers_chat_completions(files, tmp_path):
    port, pid_file = _free_port(), tmp_path / "serve.pid"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch.cli", "serve", "--device", "cpu",
         "--model", str(files / "m.m"), "--tokenizer", str(files / "t.t"),
         "--dtype", "float32", "--temperature", "0", "--seed", "1",
         "--chat-template", "llama3", "--host", "127.0.0.1", "--port", str(port),
         "--pid-file", str(pid_file), "--ts-interval", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    body = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 6,
            "temperature": 0.0}
    try:
        deadline = time.time() + 90
        while True:
            try:
                status, got = _post(port, body)
                break
            except (ConnectionRefusedError, OSError):
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(proc.stdout.read())
                time.sleep(0.25)
        assert status == 200
        assert int(pid_file.read_text()) == proc.pid
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "listening on 127.0.0.1" in out and "SIGTERM" in out
    assert not pid_file.exists()
    want_status, want = _in_process_reply(files, body)
    assert (status, got["choices"], got["usage"]) == (want_status, want["choices"],
                                                      want["usage"])


@pytest.mark.parametrize("flags,item", [(["--kv-pages", "16"], "item 6"),
                                        (["--role", "prefill"], "item 6"),
                                        (["--role", "decode"], "item 6"),
                                        (["--batch-window", "30"], "item 5")])
def test_cli_serve_refuses_unported_flags_before_loading(tmp_path, capsys, flags, item):
    absent = str(tmp_path / "absent.m")  # loading it would fail otherwise
    with pytest.raises(SystemExit) as info:
        tcli.main(["serve", "--model", absent, "--tokenizer", absent, *flags])
    assert item in str(info.value) and "ROADMAP Queue 1" in str(info.value)


def _verdicts(main, path, capsys, json_flag):
    argv = ["verify", "--model", path] + (["--json"] if json_flag else [])
    with pytest.raises(SystemExit) as info:
        main(argv)
    return info.value.code, capsys.readouterr().out


@pytest.mark.parametrize("json_flag", [False, True])
def test_cli_verify_matches_the_jax_cli(files, tmp_path, capsys, json_flag):
    good = str(files / "m.m")
    raw = bytearray(Path(good).read_bytes())
    bad = []
    for k, off in enumerate((4096, len(raw) // 2)):
        flipped = bytearray(raw)
        flipped[off] ^= 0x10
        bad.append(tmp_path / f"bad{k}.m")
        bad[-1].write_bytes(bytes(flipped))
    truncated = tmp_path / "short.m"
    truncated.write_bytes(bytes(raw[: len(raw) // 3]))
    for path in [good, *map(str, bad), str(truncated)]:
        want = _verdicts(jcli.main, path, capsys, json_flag)
        got = _verdicts(tcli.main, path, capsys, json_flag)
        assert got == want, path
        assert got[0] == (0 if path == good else 1)


def test_profile_writes_a_trace(files, tmp_path, capsys):
    tcli.main(["generate", "--device", "cpu", "--model", str(files / "m.m"),
               "--tokenizer", str(files / "t.t"), "--dtype", "float32", "--temperature",
               "0", "--steps", "4", "--profile", str(tmp_path / "prof")])
    assert "profiler trace written" in capsys.readouterr().out
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
