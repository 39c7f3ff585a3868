"""What torch.distributed offers on this machine's cards: NCCL at world
size 1, and two gloo ranks on card 0 (all-reduce, a group, a barrier, MAX,
the time of an all-reduce of 208 MB and of 2 MB of CUDA tensors), then,
in a separate pair of ranks, gloo's send/recv of CUDA tensors, which may
abort the rank (that is what it reports). One JSON line per part.

    python -m multimodal_segmentation_torch.tools.gloo_probe

parallel/collectives.py::halo_transport carries the halo over a
zero-padded all-reduce for gloo with CUDA tensors because of what this
shows on the H100 machine.
"""

import datetime
import json
import os
import socket
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(rank, port, seconds):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port, world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=seconds))


def _timed(t, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def gloo_collectives(rank, port, out):
    _init(rank, port, 60)
    res = {}
    x = torch.full((4,), float(rank), device="cuda")
    dist.all_reduce(x)
    res["all_reduce"] = x.tolist()
    g = dist.new_group([0, 1])
    y = torch.ones(3, device="cuda")
    dist.all_reduce(y, group=g)
    res["group"] = y.tolist()
    dist.barrier()
    z = torch.tensor([float(rank)], dtype=torch.float64, device="cuda")
    dist.all_reduce(z, op=dist.ReduceOp.MAX)
    res["max"] = z.item()
    res["all_reduce_208MB_s"] = _timed(torch.ones(52_070_000, device="cuda"), 4)
    res["all_reduce_2MB_s"] = _timed(torch.ones(2 * 16 * 128 * 128, device="cuda"), 10)
    with open(os.path.join(out, "gloo%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def gloo_send_recv(rank, port, out):
    _init(rank, port, 30)
    res = {}
    try:
        a = torch.full((8,), float(rank + 1), device="cuda")
        b = torch.zeros(8, device="cuda")
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, a, 1 - rank),
                                         dist.P2POp(dist.irecv, b, 1 - rank)]):
            w.wait()
        torch.cuda.synchronize()
        res["received"] = b.tolist()
    except RuntimeError as e:  # what the backend raises is the finding
        res["error"] = repr(e)[:500]
    with open(os.path.join(out, "send_recv%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        sys.exit("gloo_probe: needs a CUDA device")
    out = tempfile.mkdtemp(prefix="gloo_probe_")
    print(json.dumps({"part": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available(),
                      "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}), flush=True)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % _port(), world_size=1,
                            rank=0)
    x = torch.ones(3, device="cuda")
    dist.all_reduce(x)
    g = dist.new_group([0])
    dist.all_reduce(x, group=g)
    dist.barrier()
    print(json.dumps({"part": "nccl world size 1", "all_reduce": x.tolist(),
                      "backend": dist.get_backend(g)}), flush=True)
    dist.destroy_process_group()
    mp.spawn(gloo_collectives, args=(_port(), out), nprocs=2)
    print(json.dumps({"part": "gloo on one card", **{
        r: json.load(open(os.path.join(out, "gloo%d.json" % r))) for r in range(2)}}),
        flush=True)
    ctx = mp.start_processes(gloo_send_recv, args=(_port(), out), nprocs=2, join=False,
                             start_method="spawn")
    t0, failed = time.time(), None
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > 90:
                for p in ctx.processes:
                    p.kill()
                failed = "timed out"
                break
    except mp.ProcessExitedException as e:  # a rank that aborts is the finding
        failed = repr(e)[:300]
    ranks = {}
    for r in range(2):
        path = os.path.join(out, "send_recv%d.json" % r)
        ranks[r] = json.load(open(path)) if os.path.exists(path) else "no result"
    print(json.dumps({"part": "gloo send/recv of CUDA tensors", "failed": failed,
                      "ranks": ranks}), flush=True)


if __name__ == "__main__":
    main()
