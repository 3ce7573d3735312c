"""What decides ``correct``: the served greedy tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests the run finished (the longest of them, and others drawn from
the seed) is run through the reference once, each prompt followed by its
served tokens. For each served token the gap is the reference's best logit
at that position minus the reference's logit of the served token; the
number compared is the widest gap over the sample. A greedy program that
computes what the reference computes, at its stated precision, serves a
token whose gap is at most rounding.

The control puts the reference in the program's place at the precision
below the stated one (float8 activations): at the same positions it takes
the token the control ranks first and reads that token's gap.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

SAMPLE_SALT = 0x5EED


def load_reference(root: Path, config: dict):
    path = root / "benchmark" / config["reference"]
    spec = importlib.util.spec_from_file_location("bench_reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finished(records) -> list:
    return [r for r in records if r["error"] is None and not r["cancelled"]
            and len(r["tokens"]) == r["max_new"]]


def sample(records, seed: int, count: int) -> list:
    """The longest finished request and ``count - 1`` others drawn from the
    seed (distinct requests)."""
    done = {}
    for r in finished(records):
        done.setdefault(r["index"], r)
    pool = sorted(done.values(), key=lambda r: r["index"])
    if not pool:
        return []
    longest = max(pool, key=lambda r: (r["prompt_len"] + r["max_new"], -r["index"]))
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([int(seed) % (2 ** 63), SAMPLE_SALT])
    picks = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(picks)]


def gaps(reference, tree, shape, prompts, picked, device, control: bool = False) -> dict:
    """The widest gap of the served tokens of ``picked`` (prompts by request
    index), and with ``control`` the widest gap of the control's own first
    choices at the same positions."""
    import torch

    seqs, scored, served = [], [], []
    for r in picked:
        prompt = np.asarray(prompts[r["index"]], np.int64)
        toks = np.asarray(r["tokens"], np.int64)
        seqs.append(torch.from_numpy(np.concatenate([prompt, toks[:-1]])))
        scored.append(len(prompt) - 1)
        served.append(torch.from_numpy(toks))
    ref = reference.logits(tree, shape, seqs, scored, device)
    widest, n = 0.0, 0
    for lg, tok in zip(ref, served):
        tok = tok.to(lg.device)
        g = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(g.max()))
        n += len(tok)
    out = {"max_gap": widest, "tokens": n, "requests": len(picked)}
    if control:
        low = reference.logits(tree, shape, seqs, scored, device, precision="fp8")
        cw = 0.0
        for lg, lw in zip(ref, low):
            pick = lw.argmax(dim=-1)
            g = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
            cw = max(cw, float(g.max()))
        out["control_max_gap"] = cw
    return out
