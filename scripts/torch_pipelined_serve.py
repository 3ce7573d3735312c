"""configs/llama_pipelined.yml served from the CLI on the visible cards,
against the single-device engine of the same weights.

    python scripts/torch_pipelined_serve.py [--layers 8]

Starts ``python -m starpu_inference_server_tpu_torch.grpc.server --config
<the yml, cut to --layers>`` (4 rank processes: ``nccl`` when 4 cards are
visible, each rank on its own, ``gloo`` when they share one) and runs
``chip_smoke.py``'s ``pipelined_server_run`` on it: the port's generation
client (16 greedy requests of 32 tokens, prompts of 64, streaming then
unary), every stream equal to the single-device engine's of the same
tree in this process, tok/s and TTFT of both, rank 0's decode-step host
ms, each rank's collectives (census and host ms) and kernel launches,
and the server's backend line. Exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=8)
    args = parser.parse_args()
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
        server = cs.ServerProcess(cs.PIPE_CONFIG, Path(tmp), "llama_pipelined",
                                  {"model.options.layers": args.layers})
        try:
            server.start()
            run = cs.pipelined_server_run(server, args.layers, cs.card_line())
        except BaseException as exc:
            cs.show_logs([server])
            if not isinstance(exc, cs.SmokeFailure):
                raise
            print(f"torch_pipelined_serve: FAIL: {exc}", file=sys.stderr)
            return 1
        finally:
            server.kill()
    print(json.dumps({"ok": True, "backend": run["backend"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
