#!/usr/bin/env python3
"""Which torch.distributed collectives gloo runs on CUDA tensors, with two
ranks on one card (NCCL refuses two ranks on one device).

    python3 tools/gloo_cuda_probe.py

Spawns two processes joined by gloo on a free local port, tries each
collective on CUDA tensors, a ``DeviceMesh`` on 'cuda', and times an
``all_reduce`` of the sharded classic update's (Λ | η) at 64 streams and
D = 93 in f64; prints one line per rank and collective.
"""

from __future__ import annotations

import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, port: int, queue) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    torch.cuda.set_device(0)
    res = {}

    def attempt(name, fn):
        try:
            out = fn()
            torch.cuda.synchronize()
            res[name] = ("ok", out)
        except Exception as e:  # a collective this backend does not take on CUDA tensors
            res[name] = ("fails", str(e).splitlines()[0][:200])

    def full(value, n=3, dtype=torch.float64):
        return torch.full((n,), value, dtype=dtype, device="cuda")

    def all_reduce(dtype):
        x = full(rank + 1, 4, dtype)
        dist.all_reduce(x)
        return x.cpu().tolist()

    def all_gather():
        outs = [full(0.0) for _ in range(2)]
        dist.all_gather(outs, full(float(rank)))
        return [o.cpu().tolist() for o in outs]

    def all_gather_into_tensor():
        out = torch.empty(6, dtype=torch.float64, device="cuda")
        dist.all_gather_into_tensor(out, full(float(rank)))
        return out.cpu().tolist()

    def broadcast():
        x = full(float(rank))
        dist.broadcast(x, 0)
        return x.cpu().tolist()

    def reduce_scatter_tensor():
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, torch.ones(4, device="cuda"))
        return out.cpu().tolist()

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh

        return str(init_device_mesh("cuda", (2,), mesh_dim_names=("sp",)))

    for dtype in (torch.float64, torch.float32, torch.int64):
        attempt(f"all_reduce {dtype}", lambda dtype=dtype: all_reduce(dtype))
    for fn in (all_gather, all_gather_into_tensor, broadcast, reduce_scatter_tensor, device_mesh):
        attempt(fn.__name__, fn)
    attempt("barrier", dist.barrier)
    x = torch.randn(64, 93, 94, dtype=torch.float64, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    res["all_reduce (64, 93, 94) f64, ms per call"] = ("ok", (time.perf_counter() - t) / 10 * 1e3)
    queue.put((rank, res))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = sorted((queue.get(timeout=300) for _ in procs), key=lambda x: x[0])
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    for rank, res in out:
        for name, value in res.items():
            print(rank, name, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
