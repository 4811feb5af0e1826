"""Time the split-K and split-sequence kernels over their split counts, on the card.

    python -m dllama_tpu_torch.split_sweep [out.json]

The evidence behind two plans: ``ops/qmatmul.py`` ``gemv_plan`` (how many
K splits the Q80 decode GEMV takes at each Llama-3-8B width, T = 1) and
``ops/flash_decode.py`` ``split_plan`` (how many chunks flash decode cuts the
live cache prefix into, T in {1, 4}, pos 116 and 1000, S 1024, bf16 cache).
Each split count is checked against the plain version and timed with CUDA
events (median of 30 launches queued behind a GPU sleep; weights and cache
layers rotate so that L2 does not hold them), beside the plan's own choice
and a tiny elementwise kernel (the timing method's floor). Needs one CUDA
GPU; prints one line per shape and writes every number to ``out.json``.
"""

from __future__ import annotations

import itertools
import json
import math
import statistics
import sys

import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops import flash_decode, qmatmul

#: Llama-3-8B projection widths (K -> O)
WIDTHS = [("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w13", 4096, 28672),
          ("w2", 14336, 4096), ("wcls", 4096, 128256)]
KSPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16, 22, 32, 64)
NSPLITS = (1, 2, 4, 8, 16, 32, 64)


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call of ``fn``, in ms."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def sweep_gemv(dev, gen) -> dict:
    lib, n_sm = kernels.lib(), kernels.sm_count(dev)
    plan_per_sm = qmatmul.gemv_blocks_per_sm(1, False)
    out = {}
    for name, K, O in WIDTHS:
        def planes():
            return (torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen),
                    torch.rand((K // 32, O), device=dev, generator=gen) * 0.0003)
        copies = [planes() for _ in range(max(1, math.ceil(200e6 / (K * O * 1.125))))]
        nxt = itertools.cycle(copies).__next__
        x = torch.randn((1, K), device=dev, generator=gen).to(torch.bfloat16)
        ref = qmatmul.q80_matmul_ref(x, *copies[0])
        tiles = math.ceil(O / qmatmul._GEMV_COLS)
        res = torch.empty((1, O), device=dev)
        counters = kernels.counters(dev, tiles)
        units = K // qmatmul._GEMV_UNIT
        by = {}
        for want in KSPLITS:
            per = math.ceil(units / min(units, want))
            ksplit, rows = math.ceil(units / per), per * qmatmul._GEMV_UNIT
            if ksplit in by:
                continue
            partials = torch.empty((ksplit, 1, O), device=dev)

            def call(p):
                kernels.check(lib.dllama_q80_gemv(
                    x.data_ptr(), 0, 1, K, p[0].data_ptr(), p[1].data_ptr(), O, None, None,
                    ksplit, rows, partials.data_ptr(), counters.data_ptr(), res.data_ptr(),
                    kernels.stream_of(x)), "q80 GEMV")

            call(copies[0])
            torch.cuda.synchronize()
            err = (res - ref).abs().max().item()
            if err > 1e-5 * ref.abs().max().item():
                raise AssertionError(f"GEMV {name} ksplit {ksplit}: max abs err {err}")
            by[ksplit] = time_ms(lambda: call(nxt()))
        plan = qmatmul.gemv_plan(1, K, O, n_sm, plan_per_sm)[0]
        bound = K * O * 1.125 / 3.35e12 * 1e3
        out[name] = {"K": K, "O": O, "tiles": tiles, "bound_ms": bound, "plan_ksplit": plan,
                     "ms_by_ksplit": by}
        print(f"q80 GEMV {name} {K}->{O} ({tiles} column tiles, {plan_per_sm} blocks/SM, "
              f"bound {bound:.4f} ms; plan {plan}): "
              + "  ".join(f"{k}:{v:.4f}" for k, v in by.items()), flush=True)
        del copies
        torch.cuda.empty_cache()
    return out


def sweep_flash(dev, gen) -> dict:
    lib, n_sm = kernels.lib(), kernels.sm_count(dev)
    L, S, kv, group, hd = 64, 1024, 8, 4, 128
    kc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(torch.bfloat16)
    vc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(torch.bfloat16)
    counters = kernels.counters(dev, kv)
    scale = 1.0 / math.sqrt(hd)
    out = {}
    for T, pos in itertools.product((1, 4), (116, 1000)):
        q = torch.randn((T, kv * group, hd), device=dev, generator=gen).to(torch.bfloat16)
        res = torch.empty_like(q)
        live, R = pos + T, T * group
        ref = flash_decode.flash_decode_attention_ref(q.float(), kc, vc, pos, 2)
        by = {}
        for want in NSPLITS:
            n_split, _ = flash_decode.chunk_plan(live, want)
            if n_split in by:
                continue
            part_acc = torch.empty((kv, n_split, R, hd), device=dev)
            part_ml = torch.empty((kv, n_split, R, 2), device=dev)

            def call(layer):
                kernels.check(lib.dllama_flash_decode(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), res.data_ptr(), 1, T,
                    kv * group, hd, S, kv, None, pos, layer, scale, 1, 1, n_split, want,
                    part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(),
                    kernels.stream_of(q)), "flash decode")

            call(2)
            torch.cuda.synchronize()
            err = (res.float() - ref).abs().max().item()
            if err > 2.0 ** -7 * ref.abs().max().item():
                raise AssertionError(f"flash decode T={T} pos={pos} n_split {n_split}: {err}")
            layers = itertools.count()
            by[n_split] = time_ms(lambda: call(next(layers) % L))
        plan = flash_decode.split_plan(live, kv, n_sm)[0]
        out[f"T{T}_pos{pos}"] = {"plan_n_split": plan, "ms_by_n_split": by}
        print(f"flash decode T={T} pos={pos} (plan {plan}): "
              + "  ".join(f"{k}:{v:.4f}" for k, v in by.items()), flush=True)
    return out


def main(argv: list) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("split_sweep needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    z = torch.zeros(16, device=dev)
    result = {"device": torch.cuda.get_device_name(0),
              "floor_ms": time_ms(lambda: z.add_(1.0))}
    print(f"{result['device']}: one tiny elementwise kernel {result['floor_ms']:.4f} ms "
          f"(the timing floor)", flush=True)
    result["q80_gemv"] = sweep_gemv(dev, gen)
    result["flash_decode"] = sweep_flash(dev, gen)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
