"""The port's Grok-1 block against the reference's pinned spot values.

The reference pins the output of a 1-layer Grok-1 block whose weights come
from a seeded xorshift64* stream (`distributed-llama/src/grok1-tasks-test.cpp:
13-15,29-91`); ``tests/test_golden_grok.py`` holds the JAX package to the
same numbers. Here the port's attention block and ``_ffn_residual`` (the
MoE FFN with Grok-1's post-norms) run on the same stream, made by the
in-repo C++ generator (``native/src/xorshift_gen.cc``), and must reach the
same values at that test's tolerance (3.5e-5 abs). Skips without ``g++``,
as that test does.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import GROK_EMBEDDING_SCALE, ModelConfig
from tests.test_golden_grok import DIM, E, GOLDEN, HEAD, HIDDEN, KV_DIM, N_HEADS, N_KV, VOCAB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (several test processes share the
    CPU, and spinning thread pools would oversubscribe it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(raw: np.ndarray, *divs: float) -> np.ndarray:
    """``(float)(raw / divs[0] / divs[1] ...)`` computed in f64, as the
    reference does, a slice at a time (the stream is ~1 GB of f32)."""
    out = np.empty_like(raw)
    step = 1 << 24
    for i in range(0, raw.size, step):
        v = raw[i:i + step].astype(np.float64)
        for d in divs:
            v = v / d
        out[i:i + step] = v.astype(np.float32)
    return out


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs g++ to build the xorshift stream generator")
def test_grok1_block_matches_reference_golden(tmp_path):
    n_block = (DIM * DIM + 2 * DIM * KV_DIM + DIM * DIM + DIM * E
               + E * (2 * DIM * HIDDEN + HIDDEN * DIM) + 4 * DIM)
    n_total = n_block + DIM  # + the input activation values
    subprocess.run(["make", "-C", NATIVE, "build/xorshift-gen"], check=True,
                   capture_output=True)
    stream_path = str(tmp_path / "stream.f32")
    subprocess.run([os.path.join(NATIVE, "build", "xorshift-gen"), "123456789", str(n_total),
                    stream_path], check=True)
    raw = np.fromfile(stream_path, np.float32, count=n_total)
    assert raw.size == n_total
    os.unlink(stream_path)
    # block[f] = (float)(randomF32() / 100.0);
    # x[i] = (float)(randomF32() / 100.0 / 78.38367176906169f)
    block = _scaled(raw[:n_block], 100.0)
    x_pre = _scaled(raw[n_block:], 100.0, float(np.float32(GROK_EMBEDDING_SCALE)))
    del raw

    # the reference's load order: q, k, v, wo, router, per-expert
    # up/gate/down, then the norms; file matrices are [out, in] row-major
    pos = 0

    def take(rows, cols):
        nonlocal pos
        a = block[pos:pos + rows * cols].reshape(rows, cols)
        pos += rows * cols
        return torch.from_numpy(a.T.copy())  # kernel layout [in, out]

    wq, wk, wv, wo = take(DIM, DIM), take(KV_DIM, DIM), take(KV_DIM, DIM), take(DIM, DIM)
    router = take(E, DIM)
    ups, gates, downs = [], [], []
    for _ in range(E):
        ups.append(take(HIDDEN, DIM))
        gates.append(take(HIDDEN, DIM))
        downs.append(take(DIM, HIDDEN))
    norms = {}
    for n in ("rms_att", "rms_ffn", "rms_moe", "rms_ffn2"):
        norms[n] = torch.from_numpy(block[pos:pos + DIM].copy())
        pos += DIM
    assert pos == n_block
    del block

    cfg = ModelConfig(arch="grok1", dim=DIM, hidden_dim=HIDDEN, n_layers=1, n_heads=N_HEADS,
                      n_kv_heads=N_KV, vocab_size=VOCAB, seq_len=64, head_size=HEAD,
                      kv_dim=KV_DIM, n_experts=E, n_active_experts=2, hidden_act="gelu",
                      dtype="float32")
    assert cfg.post_norms and cfg.rope_style == "half"
    lp = {"wq": wq, "wk": wk, "wv": wv, "wo": wo, "moe_router": router,
          "moe_up": torch.stack(ups), "moe_gate": torch.stack(gates),
          "moe_down": torch.stack(downs), **norms}
    # token 0's embedding row carries the pre-scale input; embed() applies
    # Grok's input scale as grokMulInput does
    embedding = torch.zeros((VOCAB, DIM))
    embedding[0] = torch.from_numpy(x_pre)
    x = llama.embed(cfg, {"embedding": embedding}, torch.tensor([0]))
    rope = llama.rope_tables(cfg, "cpu")
    cache = llama.init_cache(cfg, device="cpu")
    att = llama._attn_block(cfg, lp, rope, x, cache["k"], cache["v"], 0, 0)
    out = llama._ffn_residual(cfg, lp, x, att)[0].numpy()
    for off, want in GOLDEN.items():
        np.testing.assert_allclose(out[off:off + 4], np.asarray(want, np.float32), atol=3.5e-5,
                                   err_msg=f"offset {off}")
