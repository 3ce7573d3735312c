"""A mesh config served from the CLI on the visible cards, against the
single-device engine of the same weights.

    python scripts/torch_pipelined_serve.py [--layers 8]
    python scripts/torch_pipelined_serve.py --gspmd [--launchers 2]

Default: ``configs/llama_pipelined.yml`` cut to ``--layers``. Starts
``python -m starpu_inference_server_tpu_torch.grpc.server --config <the
yml>`` (4 rank processes: ``nccl`` when 4 cards are visible, each rank on
its own, ``gloo`` when they share one) and runs ``chip_smoke.py``'s
``pipelined_server_run`` on it: the port's generation client (16 greedy
requests of 32 tokens, prompts of 64, streaming then unary), every stream
equal to the single-device engine's of the same tree in this process,
tok/s and TTFT of both, rank 0's decode-step host ms, each rank's
collectives (census and host ms) and kernel launches, and the server's
backend line. Exits 1 on any mismatch.

``--gspmd``: ``configs/llama_decoder.yml`` (llama-1b int4, 128 slots) at
``devices.mesh: {data: 2, model: 2}`` instead, through ``chip_smoke.py``'s
``gspmd_server_run`` (32 greedy requests of 32 tokens, prompts of 64,
streaming: tok/s, TTFT, rank 0's decode-step host ms, the census and the
launches by rank); then the single-device engine of the same tree in
this process generates every request's stream, and the streams equal to
the mesh's are counted (the tensor-parallel sums run in another order,
so bf16 streams may part; printed, not required).

``--gspmd --launchers 2``: the same server as two CLI launchers of two
ranks each joined at a local coordinator (``distributed:
{coordinator_address, num_processes: 2, process_id: 0|1}``), each with
half of the visible cards as its ``devices.device_ids`` (four cards:
``nccl``, a rank a card; one card: ``gloo``), through ``chip_smoke.py``'s
``multihost_server_run`` (the axes crossing launchers, each rank's
collectives over them, the weights sent to launcher 1 and their
seconds); launcher 1 must exit 0 after launcher 0's shutdown.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gspmd_streams(run: dict) -> dict:
    """The single-device engine of llama_decoder.yml's tree (seeded as the
    server's) on every request of ``run``: how many streams equal the
    mesh's, and how many first tokens."""
    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    engine = build_generation_engine(load_config(str(cs.CONFIG)), device="cuda")
    engine.start()
    try:
        pool = run["prompts"]
        ref = [engine.generate(p, cs.GSPMD_TOKENS, timeout=600.0) for p in pool]
    finally:
        engine.stop()
    pairs = [(toks, ref[rid % len(pool)]) for rid, toks in run["tokens"].items()]
    out = {"streams": len(pairs), "equal": sum(a == b for a, b in pairs),
           "first_token_equal": sum(a[:1] == b[:1] for a, b in pairs)}
    print(f"llama_decoder data=2 model=2 against one device: {out['equal']} of {out['streams']} "
          f"streams equal, {out['first_token_equal']} first tokens equal")
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--gspmd", action="store_true",
                        help="llama_decoder.yml at data=2 x model=2 instead")
    parser.add_argument("--launchers", type=int, default=1, choices=(1, 2),
                        help="with --gspmd: serve as this many CLI launchers")
    args = parser.parse_args()
    if args.launchers > 1 and not args.gspmd:
        parser.error("--launchers 2 needs --gspmd")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from starpu_inference_server_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_pipelined_serve: FAIL: no CUDA device", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"cards ({torch.cuda.device_count()} visible): {'; '.join(cards.strip().splitlines())}",
          flush=True)
    _build.build_all()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        if args.launchers > 1:
            cards = torch.cuda.device_count()
            halves = [list(range(cards // 2)), list(range(cards // 2, cards))] \
                if cards >= 2 else None
            servers = cs.launcher_pair(cs.CONFIG, Path(tmp), "llama_multihost",
                                       {"devices.mesh": cs.GSPMD_MESH}, device_ids=halves)
        elif args.gspmd:
            servers = [cs.ServerProcess(cs.CONFIG, Path(tmp), "llama_gspmd",
                                        {"devices.mesh": cs.GSPMD_MESH})]
        else:
            servers = [cs.ServerProcess(cs.PIPE_CONFIG, Path(tmp), "llama_pipelined",
                                        {"model.options.layers": args.layers})]
        try:
            for server in servers:
                server.start()
            if args.launchers > 1:
                run = cs.multihost_server_run(servers, cs.card_line())
                run["streams"] = gspmd_streams(run)
            elif args.gspmd:
                run = cs.gspmd_server_run(servers[0], cs.card_line())
                run["streams"] = gspmd_streams(run)
            else:
                run = cs.pipelined_server_run(servers[0], args.layers, cs.card_line())
        except BaseException as exc:
            cs.show_logs(servers)
            if not isinstance(exc, cs.SmokeFailure):
                raise
            print(f"torch_pipelined_serve: FAIL: {exc}", file=sys.stderr)
            return 1
        finally:
            for server in servers:
                server.kill()
    print(json.dumps({"ok": True, "backend": run["backend"],
                      **({"streams": run["streams"]} if args.gspmd else {})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
