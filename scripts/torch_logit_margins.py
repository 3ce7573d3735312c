"""The top-two logit margin of a decoder config's first token, for the
generation client's pooled prompts.

    python scripts/torch_logit_margins.py [--config configs/llama_decoder.yml] [--device cpu]

Builds the config's model from its seed (single device) and prefills each
of ``clients/client.py:pooled_prompts`` (64 tokens, the client's seed),
printing the three largest logits of the first generated token and the gap
between the first two. A gap at or below the bf16 spacing of the logits
(1/64 near 4) is a tie that any reordered sum can flip: it is what a
mesh's streams are read against when they part from one device's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=str(ROOT / "configs" / "llama_decoder.yml"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt-len", type=int, default=64)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from starpu_inference_server_tpu_torch.clients.client import pooled_prompts
    from starpu_inference_server_tpu_torch.serving.generation import build_generation_engine
    from starpu_inference_server_tpu_torch.utils.config import load_config

    engine = build_generation_engine(load_config(args.config), device=args.device)
    for i, prompt in enumerate(pooled_prompts(args.prompt_len)):
        ids = torch.from_numpy(np.asarray(prompt, np.int32)).to(engine.device)
        with torch.inference_mode():
            _, logits = engine._prefill_fn(engine.spec, engine.params, engine.cache, ids,
                                           len(prompt), 0, engine.dtype)
        top = torch.topk(logits.float(), 3).values.tolist()
        print(f"pooled prompt {i}: top logits {', '.join(f'{v:.4f}' for v in top)}; "
              f"margin {top[0] - top[1]:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
