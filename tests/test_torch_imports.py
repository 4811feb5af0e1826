"""The port's package boundary and device rules.

* Importing every module of ``dllama_tpu_torch`` pulls in neither ``jax``
  nor any module of ``dllama_tpu`` (checked in a fresh interpreter).
* Entry points run on the card unless the caller asks for the CPU: without a
  GPU, ``Engine`` and ``load_engine`` raise instead of quietly moving.
* A kernel wrapper given CPU tensors runs its plain version and counts no
  launch.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops import flash_decode, fused_rope_cache, qmatmul
from dllama_tpu_torch.ops.rope import rope_table

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import dllama_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dllama_tpu_torch.__path__, "dllama_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dllama_tpu"))
print(len(names), "modules;", "foreign:", bad)
new = {"dllama_tpu_torch.qkernel_experiments", "dllama_tpu_torch.ops.qmatmul"}
sys.exit(1 if bad or len(names) < 20 or not new <= set(names) else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny_cfg():
    return ModelConfig(arch="llama", dim=64, hidden_dim=96, n_layers=1, n_heads=4,
                       n_kv_heads=2, vocab_size=32, seq_len=16, head_size=16, kv_dim=32)


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.runtime.generate import Engine

    cfg = _tiny_cfg()
    params = llama.random_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    for default_on_card in (lambda: llama.random_params(cfg), lambda: llama.init_cache(cfg),
                            lambda: llama.rope_tables(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_on_card()
    Engine(cfg, params, device="cpu")  # the CPU when asked for
    args = cli.build_parser().parse_args(
        ["generate", "--model", str(tmp_path / "absent.m"), "--tokenizer", "t.t"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.load_engine(args)


def test_kernel_wrappers_run_their_plain_versions_on_cpu_tensors():
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    qt = qmatmul.quantize_tensor(rng.standard_normal((128, 48)).astype(np.float32), "q40", "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    assert torch.equal(qmatmul.q40_matmul(x, qt.w, qt.s, qt.s2),
                       qmatmul.q40_matmul_ref(x, qt.w, qt.s, qt.s2))

    q = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    assert torch.equal(flash_decode.flash_decode_attention(q, kc, vc, 5, 1),
                       flash_decode.flash_decode_attention_ref(q, kc, vc, 5, 1))

    cos, sin = (torch.from_numpy(t) for t in rope_table(16, 16, 10000.0))
    k, v = q[:, :2], q[:, 2:]
    a = (kc.clone(), vc.clone())
    b = (kc.clone(), vc.clone())
    qa = fused_rope_cache.rope_cache_update(q, k, v, cos, sin, *a, 3, 0)
    qb = fused_rope_cache.rope_cache_update_ref(q, k, v, cos, sin, *b, 3, 0)
    assert torch.equal(qa, qb) and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], kc)  # it did write
    assert set(kernels.launches.values()) == {0}


def test_kernel_wrappers_reject_other_devices():
    w = torch.zeros(32, 8, dtype=torch.uint8, device="meta")
    s = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qmatmul.q40_matmul(torch.zeros(1, 64, device="meta"), w, s, s)
    cache = torch.zeros(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_decode.flash_decode_attention(torch.zeros(1, 1, 16, device="meta"), cache, cache, 0, 0)
