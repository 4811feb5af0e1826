"""Time all-gathers on the card at the tensor-parallel decode payloads.

    python -m dllama_tpu_torch.parallel.gather_probe

For NCCL at one rank and gloo at 1, 2 and 4 ranks (every rank a process on
``cuda:0``, the only way a one-card machine can hold more than one rank;
NCCL refuses two ranks on one device), each rank gathers the payloads of a
Llama-3-8B decode step's gathers at its shard width — the heads or a
layer's output (dim 4096, bf16), the FFN hidden (14336, f32), a Q80-wire
payload (int8), the logits (128256, f32) and a 128-row prefill (bf16) —
straight from CUDA tensors ("cuda") and staged through host memory
("staged"). Prints, for rank 0, whether the gather equals the expected
concatenation and the mean ms of 200 gathers. Needs one CUDA GPU.
"""

import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: (name, rows, whole width, dtype) of each payload
PAYLOADS = [("d4096_bf16", 1, 4096, torch.bfloat16), ("h14336_f32", 1, 14336, torch.float32),
            ("q80_int8", 1, 4608, torch.int8), ("logits", 1, 128256, torch.float32),
            ("prefill", 128, 4096, torch.bfloat16)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, size: int, port: int, backend: str, q) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size,
                            rank=rank)
    out = {}
    for name, rows, width, dt in PAYLOADS:
        shape = (rows, width // size)

        def local(r):
            return (torch.arange(shape[0] * shape[1], device=dev).reshape(shape) % 100
                    + r * 1000).to(dt)

        x = local(rank)
        for mode in ("cuda", "staged"):
            def gather():
                if mode == "cuda":
                    parts = [torch.empty_like(x) for _ in range(size)]
                    dist.all_gather(parts, x)
                    return torch.cat(parts, -1)
                h = x.cpu()
                parts = [torch.empty_like(h) for _ in range(size)]
                dist.all_gather(parts, h)
                return torch.cat(parts, -1).to(dev)

            try:
                y = gather()
                torch.cuda.synchronize()
                ok = bool(torch.equal(y, torch.cat([local(r) for r in range(size)], -1)))
                n = 200
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(n):
                    y = gather()
                torch.cuda.synchronize()
                out[f"{name}/{mode}"] = (ok, round((time.perf_counter() - t0) * 1e3 / n, 4))
            except Exception as e:  # a backend that refuses a mode: reported, not fatal
                out[f"{name}/{mode}"] = ("ERR", repr(e)[:300])
    q.put((rank, out))
    dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gather_probe: needs a CUDA GPU")
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    ctx = mp.get_context("spawn")
    for backend, size in (("nccl", 1), ("gloo", 1), ("gloo", 2), ("gloo", 4)):
        q = ctx.Queue()
        port = free_port()
        t0 = time.perf_counter()
        ps = [ctx.Process(target=worker, args=(r, size, port, backend, q)) for r in range(size)]
        for p in ps:
            p.start()
        res = [q.get(timeout=300) for _ in ps]
        for p in ps:
            p.join()
        print(f"== {backend} x{size} ({time.perf_counter() - t0:.1f} s incl. start)", flush=True)
        for r, out in sorted(res):
            if r == 0:
                for k, v in out.items():
                    print(f"  rank{r} {k}: {v}", flush=True)


if __name__ == "__main__":
    main()
