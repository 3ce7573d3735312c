"""Which ``torch.distributed`` operations two rank processes that share
one GPU can run, and what they cost.

    python scripts/torch_gloo_probe.py [--out build/gloo_probe.json]

Prints the card (``nvidia-smi`` name and power limit),
``torch.distributed.is_nccl_available()``, then one line per case:

- ``gloo <op>``: two gloo ranks on ``cuda:0``, the op on CUDA tensors
  (``all_reduce``, ``broadcast``, ``all_gather``,
  ``all_gather_into_tensor``, ``reduce``, ``send_recv``, ``isend_irecv``,
  ``batch_isend_irecv``), its result checked; each op in a world of its
  own, since an op gloo does not take on CUDA tensors may kill the
  process;
- ``gloo timing``: milliseconds per call (host clock, after a
  synchronise) of a send/recv and an all_reduce of a bf16 [4, 1, 4096]
  and a f32 [16, 32000] tensor, staged through pinned host buffers, and
  of the same all_reduce on the CUDA tensor where gloo takes it;
- ``nccl same device``: two nccl ranks on ``cuda:0`` and one
  all_reduce, which NCCL is expected to refuse.

Each world runs as two child processes of this script, joined through a
``file://`` store in a temporary directory, with a time limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce",
       "send_recv", "isend_irecv", "batch_isend_irecv")


def _child(case: str, rank: int, init: str) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    backend = "nccl" if case == "nccl" else "gloo"
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    peer = 1 - rank
    try:
        if case == "nccl":
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            return {"ok": bool((x == 2).all()), "value": x.tolist()}
        if case == "timing":
            return _timing(rank, peer, dev)
        x = torch.full((4,), float(rank + 1), device=dev)
        if case == "all_reduce":
            dist.all_reduce(x)
            want = [3.0] * 4
        elif case == "broadcast":
            dist.broadcast(x, src=0)
            want = [1.0] * 4
        elif case == "all_gather":
            outs = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(outs, x)
            x = torch.cat(outs)
            want = [1.0] * 4 + [2.0] * 4
        elif case == "all_gather_into_tensor":
            out = torch.empty(8, device=dev)
            dist.all_gather_into_tensor(out, x)
            x = out
            want = [1.0] * 4 + [2.0] * 4
        elif case == "reduce":
            dist.reduce(x, dst=0)
            want = [3.0] * 4 if rank == 0 else None
        elif case == "send_recv":
            if rank == 0:
                dist.send(x, dst=peer)
                want = [1.0] * 4
            else:
                dist.recv(x, src=peer)
                want = [1.0] * 4
        elif case == "isend_irecv":
            y = torch.empty_like(x)
            works = [dist.isend(x, dst=peer), dist.irecv(y, src=peer)]
            for w in works:
                w.wait()
            x = y
            want = [float(peer + 1)] * 4
        elif case == "batch_isend_irecv":
            y = torch.empty_like(x)
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                            dist.P2POp(dist.irecv, y, peer)])
            for w in works:
                w.wait()
            x = y
            want = [float(peer + 1)] * 4
        else:
            raise ValueError(case)
        torch.cuda.synchronize()
        got = x.tolist()
        return {"ok": want is None or got == want, "value": got}
    finally:
        dist.destroy_process_group()


def _timing(rank: int, peer: int, dev) -> dict:
    import torch
    import torch.distributed as dist

    out = {}
    shapes = {"bf16[4,1,4096]": ((4, 1, 4096), torch.bfloat16),
              "f32[16,32000]": ((16, 32000), torch.float32)}
    reps = 50
    for name, (shape, dtype) in shapes.items():
        x = torch.randn(shape, device=dev).to(dtype)
        host = torch.empty(shape, dtype=dtype, pin_memory=True)

        def staged_p2p():
            if rank == 0:
                host.copy_(x)
                dist.send(host, dst=peer)
            else:
                dist.recv(host, src=peer)
                x.copy_(host, non_blocking=True)
                torch.cuda.synchronize()

        def staged_allreduce():
            host.copy_(x)
            dist.all_reduce(host)
            x.copy_(host, non_blocking=True)
            torch.cuda.synchronize()

        def cuda_allreduce():
            dist.all_reduce(x)
            torch.cuda.synchronize()

        for label, fn in (("staged send/recv", staged_p2p),
                          ("staged all_reduce", staged_allreduce),
                          ("cuda all_reduce", cuda_allreduce)):
            try:
                for _ in range(5):
                    fn()
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                dist.barrier()
                out[f"{label} {name} ms"] = (time.perf_counter() - t0) * 1e3 / reps
            except RuntimeError as exc:  # an op gloo refuses on CUDA tensors
                out[f"{label} {name} ms"] = f"error: {exc}"[:200]
    return {"ok": True, "timing": out}


def _world(case: str, tmp: str) -> list:
    init = f"file://{tmp}/{case}.store"
    return [subprocess.Popen([sys.executable, __file__, "--child", case, "--rank", str(r),
                              "--init", init], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(2)]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--child")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--init")
    parser.add_argument("--out", default="build/gloo_probe.json")
    parser.add_argument("--timeout", type=float, default=180.0)
    args = parser.parse_args()
    if args.child:
        try:
            res = _child(args.child, args.rank, args.init)
        except Exception as exc:  # noqa: BLE001 - the probe reports every failure
            res = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:400]}
        print("RESULT " + json.dumps(res), flush=True)
        return 0

    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    report = {"card": card.strip(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "nccl_available": torch.distributed.is_nccl_available(), "cases": {}}
    print("torch.distributed.is_nccl_available():", report["nccl_available"])
    with tempfile.TemporaryDirectory() as tmp:
        cases = list(OPS) + ["timing", "nccl"]
        worlds = {c: _world(c, tmp) for c in cases}
        deadline = time.monotonic() + args.timeout
        for case, procs in worlds.items():
            ranks = []
            for r, p in enumerate(procs):
                try:
                    out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                    line = next((ln for ln in out.splitlines() if ln.startswith("RESULT ")), None)
                    res = json.loads(line[7:]) if line else {
                        "ok": False, "exit": p.returncode, "stderr": err[-400:]}
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
                    res = {"ok": False, "error": f"timed out after {args.timeout:g} s"}
                ranks.append(res)
            report["cases"][case] = ranks
            label = {"nccl": "nccl same device", "timing": "gloo timing"}.get(case, f"gloo {case}")
            print(label, json.dumps(ranks)[:600], flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
