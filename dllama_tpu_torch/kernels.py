"""Builder and loader of the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu``, each with a plain C interface. At first use
every source is compiled by its own ``nvcc`` (all started together) for
``sm_90a``, the objects are linked into ONE shared library, and the library
is loaded with ``ctypes``. The library lands in ``build/torch_kernels/`` at
the repository root, named by a hash of the sources and flags: a changed
source rebuilds, an unchanged one loads what is there. A failed build raises;
nothing falls back. ptxas reports each kernel's registers, stack and spills
(``-Xptxas -v``); the report is kept beside the library (:func:`build_log`).

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches; :func:`check` turns a
non-zero code into an exception. Each wrapper in ``ops`` adds one to its
entry in :data:`launches` where it launches its kernel, and nowhere else, so a
run can show which kernels the main path went through.

Kernels that split work across blocks and merge it in the last block to
arrive — the Q40 and Q80 decode GEMVs (K1, K3, K6, and their
expert-indexed forms, a run of counters per expert) and flash decode (K4) —
share one buffer of arrival counters per device (:func:`counters`):
it starts zeroed, each such kernel leaves every counter it used at 0 again,
and so launches that use it must not overlap — the port issues them on one
stream.

A CUDA graph (``runtime.graphs``) replays launches without running the
wrappers, so the counts of a captured step are taken at capture
(:func:`counted`) and added on every replay (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"q40_matmul": 0, "q80_matmul": 0, "q40_matmul_stacked": 0,
            "q80_matmul_stacked": 0, "flash_decode": 0, "rope_cache_update": 0,
            "flash_decode_batched": 0, "rope_cache_update_batched": 0,
            "rope_cache_update_verify": 0,
            "q40_nosub_matmul": 0, "q40_int8_matmul": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C entry points and their argument types (every pointer and the stream
#: as c_void_p, so ctypes never truncates one to 32 bits)
_SIGNATURES = {
    # x, x_f32, T, K, w, s_lo, s_hi, O, mode, inv, norm_w, wide, ksplit, rows_per_split,
    # partials, counters, out, stream
    "dllama_q40_gemv": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                        _P),
    # x, x_stride, T, K, w, s_lo, s_hi, O, w_stride, s_stride, ids, base, n_ids, n_sel,
    # mode, ksplit, rows_per_split, partials, counters, out, stream
    "dllama_q40_gemv_indexed": (_P, _L, _I, _I, _P, _P, _P, _I, _L, _L, _P, _I, _I, _I, _I,
                                _I, _I, _P, _P, _P, _P),
    # T, wide -> resident Q40 GEMV blocks per SM
    "dllama_q40_gemv_blocks_per_sm": (_I, _I),
    # x, x_f32, T, K, w, s_lo, s_hi, O, mode, inv, norm_w, ksplit, sb_per_split,
    # partials, out, stream
    "dllama_q40_tile": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P),
    # x, x_f32, T, K, w, scales, O, inv, norm_w, ksplit, sb_per_split, partials, out,
    # stream
    "dllama_q80_tile": (_P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P),
    # xq, sx, T, K, w, s_lo, s_hi, O, ksplit, rows_per_split, partials, counters, out, stream
    "dllama_q40_int8_matmul": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # T -> resident K7 blocks per SM
    "dllama_q40_int8_blocks_per_sm": (_I,),
    # x, x_f32, T, K, w, scales, O, inv, norm_w, ksplit, rows_per_split, partials,
    # counters, out, stream
    "dllama_q80_gemv": (_P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P),
    # x, x_stride, T, K, w, scales, O, w_stride, s_stride, ids, base, n_ids, n_sel, ksplit,
    # rows_per_split, partials, counters, out, stream
    "dllama_q80_gemv_indexed": (_P, _L, _I, _I, _P, _P, _I, _L, _L, _P, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P),
    # T, x_f32 -> resident GEMV blocks per SM
    "dllama_q80_gemv_blocks_per_sm": (_I, _I),
    # q, k_cache, v_cache, out, B, T, H, hd, S, kv, pos_dev, pos, layer, scale, act_kind,
    # cache_kind, n_split, max_split, part_acc, part_ml, counters, stream
    "dllama_flash_decode": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _F, _I, _I,
                            _I, _I, _P, _P, _P, _P),
    # q, q_rs, k, k_rs, v, v_rs, cos, sin, q_out, k_cache, v_cache, B, T, H, kv, hd, S, R,
    # pos_dev, pos, layer, half_style, angle_at_write, act_kind, cache_kind, stream
    "dllama_rope_cache_update": (_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # CUDA error code -> its message
    "dllama_error_string": (_I,),
}
#: the entry points that return something other than an int
_RESTYPES = {"dllama_error_string": ctypes.c_char_p}

#: arrival counters per device (see the module docstring)
N_COUNTERS = 4096

_lib = None
_lock = threading.Lock()
_counters: dict = {}
_sm_counts: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class counted:
    """Within the block, the wrappers' counts go to :attr:`counts` (what
    the block launched, or captured) and :data:`launches` is left as it
    was: a capture launches nothing until it is replayed."""

    def __enter__(self) -> "counted":
        self._saved = dict(launches)
        self.counts: dict = {}
        return self

    def __exit__(self, *exc) -> None:
        self.counts = {k: launches[k] - self._saved[k] for k in launches
                       if launches[k] != self._saved[k]}
        launches.update(self._saved)


def add_launches(counts: dict, times: int = 1) -> None:
    """Count ``times`` replays of a graph that captured ``counts``."""
    for name, n in counts.items():
        launches[name] += n * times


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdllama_torch_kernels-{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """Where the build of the current sources keeps nvcc's output."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile and link the kernels unless the library for these sources
    exists. Returns its path; raises with nvcc's output on failure."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        failed, logs = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"--- {src.name} (exit {proc.returncode}) ---\n{out}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (tmp / "build.log").write_text("\n".join(logs))
        lib_tmp = tmp / so.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                               "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
        os.replace(tmp / "build.log", build_log())
        os.replace(lib_tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().dllama_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed int32 arrival counters, allocated once; raises
    if a launch needs more than :data:`N_COUNTERS`, and if the first use is
    inside a CUDA graph capture (the buffer would live in the graph's pool:
    a graph's warm-up allocates it)."""
    if n > N_COUNTERS:
        raise ValueError(f"a launch needs {n} arrival counters, the buffer has {N_COUNTERS}")
    with _lock:
        buf = _counters.get(device)
        if buf is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the arrival counters must exist before a CUDA graph "
                                   "capture: warm the step up first")
            buf = _counters[device] = torch.zeros(N_COUNTERS, dtype=torch.int32, device=device)
    return buf


def sm_count(device: torch.device) -> int:
    """The device's streaming multiprocessors (cached)."""
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream
