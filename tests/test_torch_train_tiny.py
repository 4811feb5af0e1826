"""``python -m dllama_tpu_torch.train_tiny_e2e`` on the CPU (the port of
``scripts/train_tiny_e2e.py``): a short run of its steps, its files read
back by the port's readers, and its gate's exit code.

52 steps (the warmup-cosine schedule needs more than its 50 warmup steps)
do not memorise the corpus: the run must still train (the loss read at
step 50 under the one at step 0), write a Q40 `.m` file, its f32 twin and
the `.t` tokenizer that the port's readers load, serve the file, and exit
1 through its 95 % prefix gate with ``--no-cli``. The memorisation itself
(exit 0, through the engine and ``cli generate``) runs on the card, in
``chip_smoke.py`` phase 12(e).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from dllama_tpu_torch.formats.tokenizer_file import read_tokenizer
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.quants import blocks
from dllama_tpu_torch.train_tiny_e2e import CORPUS, N_PROMPT, N_STEPS, prefix_match

ROOT = Path(__file__).resolve().parent.parent


def test_short_run_trains_writes_serves_and_exits_by_its_gate(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.train_tiny_e2e",
                           str(tmp_path), "--steps", "52", "--no-cli", "--device", "cpu"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    res = json.loads((tmp_path / "e2e_result.json").read_text())
    assert res["steps"] == 52 and res["device"] == "cpu"
    assert res["final_loss"] < res["first_loss"]
    assert res["in_process_ok"] is False and res["cli_ok"] is None
    assert res["match_tokens"] < int(0.95 * N_STEPS) and res["expected_tokens"] == N_STEPS
    assert "f32 twin match" in proc.stdout
    tok = read_tokenizer(str(tmp_path / "tiny.t"))
    assert len(tok.vocab) == 259 and tok.bos_id == 1
    with WeightFileReader(str(tmp_path / "tiny.m")) as r:
        assert r.spec.weights_float_type == blocks.Q40 and r.spec.dim == 256
        assert r.spec.n_layers == 4 and r.spec.vocab_size == 259
        q40_emb = r.read_tensor("token_embedding", np.float32)
    with WeightFileReader(str(tmp_path / "tiny_f32.m")) as r:
        assert r.spec.weights_float_type == blocks.F32
        f32_emb = r.read_tensor("token_embedding", np.float32)
    assert q40_emb.shape == f32_emb.shape == (259, 256)


def test_prefix_gate_counts_the_leading_run():
    assert prefix_match([1, 2, 3, 9], [1, 2, 3, 4]) == 3
    assert prefix_match([], [1]) == 0
    assert CORPUS[N_PROMPT - 1:N_PROMPT - 1 + N_STEPS].startswith("le of recorded time;")
