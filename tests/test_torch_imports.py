"""The port's package boundary and device rules.

* Importing every module of ``dllama_tpu_torch`` pulls in neither ``jax``
  nor any module of ``dllama_tpu`` (checked in a fresh interpreter), nor
  ``optax`` or ``orbax``; the training and native export modules are among
  them.
* Entry points run on the card unless the caller asks for the CPU: without a
  GPU, ``Engine`` and ``load_engine`` raise instead of quietly moving.
* A kernel wrapper given CPU tensors runs its plain version and counts no
  launch.
* The fleet's control plane (``serving.{evloop,router,autoscale,fleet}``,
  ``obsv.forensics``) and the CLI modes ``router``, ``fleet``, ``top``,
  ``explain`` and ``snapshot`` import no ``torch`` either, and the replicas a
  fleet spawns without ``--device cpu`` refuse to run without a GPU.
"""

import os
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
new = {"dllama_tpu_torch.qkernel_experiments", "dllama_tpu_torch.ops.qmatmul",
       "dllama_tpu_torch.serving.api_server", "dllama_tpu_torch.faults",
       "dllama_tpu_torch.runtime.train", "dllama_tpu_torch.runtime.checkpoint",
       "dllama_tpu_torch.ops.ring_attention", "dllama_tpu_torch.parallel.pipeline",
       "dllama_tpu_torch.parallel.grad_collectives", "dllama_tpu_torch.train_tiny_e2e",
       "dllama_tpu_torch.export_native", "dllama_tpu_torch.native_launch"}
bad += sorted(m for m in sys.modules if m.split(".")[0] in ("optax", "orbax"))
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


_CONTROL_PLANE = """
import sys
for name in ("torch", "jax", "dllama_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
from dllama_tpu_torch import cli
from dllama_tpu_torch.obsv import forensics
from dllama_tpu_torch.serving import autoscale, evloop, fleet, router
router.run_router = lambda args: print("router mode", args.replica)
fleet.run_fleet = lambda args: print("fleet mode", args.replicas)
codes = []
for argv in (["router", "--replica", "127.0.0.1:1"],
             ["fleet", "--model", "m.m", "--tokenizer", "t.t", "--replicas", "3"],
             ["top", "--router", "127.0.0.1:1", "--iterations", "1"],
             ["explain", "req-x", "--trace", "absent.json"],
             ["snapshot", "--router", "127.0.0.1:1", "--out", sys.argv[1]]):
    try:
        cli.main(argv)
        codes.append(None)
    except SystemExit as e:
        codes.append(e.code)
print("codes", codes)
print("foreign", sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "dllama_tpu")
                        and sys.modules[m] is not None))
"""


def test_control_plane_and_its_cli_modes_import_no_torch(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _CONTROL_PLANE, str(tmp_path / "s.tgz")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "router mode ['127.0.0.1:1']" in out and "fleet mode 3" in out
    # top draws its unreachable frame (0); explain and snapshot find nothing (1)
    assert "codes [None, None, 0, 1, 1]" in out and "foreign []" in out


def test_fleet_replicas_without_device_cpu_refuse_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
    from dllama_tpu_torch.formats.weights import tensor_plan, write_model
    from dllama_tpu_torch.quants import blocks
    from dllama_tpu_torch.serving.fleet import Fleet
    from tests.torch_ports import port_block

    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=1, n_heads=4,
                     n_kv_heads=2, vocab_size=260, seq_len=32, weights_float_type=blocks.Q40)
    write_model(str(tmp_path / "m.m"), spec,
                {e.name: np.zeros(e.d * e.n, np.float32) for e in tensor_plan(spec)})
    write_tokenizer(str(tmp_path / "t.t"), TokenizerData(
        vocab=[b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)] + [b"hi"],
        scores=[0.0] * 260, bos_id=1, eos_id=2))
    argv = Fleet(str(tmp_path / "m.m"), "t.t")._replica_argv(1)
    base = port_block(3)  # the replica's port, a spare, the router's
    assert argv[1:4] == ["-m", "dllama_tpu_torch.cli", "serve"] and "--device" not in argv
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch.cli", "fleet", "--model", str(tmp_path / "m.m"),
         "--tokenizer", str(tmp_path / "t.t"), "--replicas", "1", "--max-restarts", "0",
         "--base-port", str(base), "--port", str(base + 2), "--ready-timeout", "60",
         "--log-dir", str(tmp_path / "logs")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    log = (tmp_path / "logs" / "replica-0.log").read_text()
    assert proc.returncode != 0 and "exited with 1 before becoming ready" in proc.stderr
    assert "no CUDA device" in log
