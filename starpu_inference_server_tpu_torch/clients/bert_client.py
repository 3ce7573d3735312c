#!/usr/bin/env python3
"""BERT inference client: tokenize text, send ModelInfer, report stats.

Counterpart of ``starpu_inference_server_tpu/clients/bert_client.py``. Run
it as

    python -m starpu_inference_server_tpu_torch.clients.bert_client --seq-len 512 \\
        --text "first sentence" --text "second sentence" --validate

Reference counterpart: client/bert_inference_client.py (445 LoC) —
tokenizes ``--text`` sentences with the HF tokenizer at max_length 128,
builds a ModelInferRequest with raw contents + client_send_ms, prints
output statistics, and optionally validates against a local reference
model with rtol/atol. The local reference is the port's FP32
``bert-base-uncased`` (seed 42) on ``cuda``, or on the CPU with
``--device cpu``.

Differs from the JAX client in one place: the offline tokenizer hashes
words with ``zlib.crc32``, where the JAX client's ``hash()`` is salted
per process (``PYTHONHASHSEED``), so the same text gives the same ids in
every run.
"""

from __future__ import annotations

import argparse
import asyncio
import zlib

import grpc
import numpy as np

from ..utils.clock import wall_ms
from . import _pb

SEQ_LEN = 128


def tokenize(texts, seq_len: int):
    """The HF tokenizer when it loads from the local cache (never from
    the network), else a whitespace + stable-hash fallback so the client
    works offline."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("bert-base-uncased", local_files_only=True)
        enc = tok(
            list(texts),
            padding="max_length",
            truncation=True,
            max_length=seq_len,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int64), enc["attention_mask"].astype(np.int64)
    except Exception:
        ids = np.zeros((len(texts), seq_len), np.int64)
        mask = np.zeros((len(texts), seq_len), np.int64)
        for i, text in enumerate(texts):
            words = text.lower().split()[: seq_len - 2]
            toks = [101] + [1000 + zlib.crc32(w.encode()) % 28000 for w in words] + [102]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


async def infer(target, model, ids, mask, timeout=60.0):
    channel = grpc.aio.insecure_channel(target)
    rpc = channel.unary_unary(
        "/inference.GRPCInferenceService/ModelInfer",
        request_serializer=_pb.ModelInferRequest.SerializeToString,
        response_deserializer=_pb.ModelInferResponse.FromString,
    )
    req = _pb.ModelInferRequest(model_name=model, id="bert-client")
    for name, arr in (("input_ids", ids), ("attention_mask", mask)):
        t = req.inputs.add()
        t.name = name
        t.datatype = "INT64"
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    req.client_send_ms = int(wall_ms())
    resp = await rpc(req, timeout=timeout)
    await channel.close()
    return resp


def validate_with_reference(hidden, ids, mask, rtol, atol, device=None):
    """The port's FP32 ``bert-base-uncased`` (seed 42) on ``device``
    (default ``cuda``), run on the same ids and mask (the reference
    client loads a local TorchScript model for the same purpose)."""
    import torch

    from ..models.registry import build_model
    from ..utils.config import ModelSettings

    model = build_model(
        ModelSettings(family="bert-base-uncased", compute_dtype="FP32"), seed=42,
        device=device,
    )
    with torch.no_grad():
        ref = model.apply({
            "input_ids": torch.from_numpy(ids).to(model.device),
            "attention_mask": torch.from_numpy(mask).to(model.device),
        })["last_hidden_state"]
    close = np.allclose(hidden, ref.cpu().numpy(), rtol=rtol, atol=atol)
    print(f"reference validation: {'OK' if close else 'MISMATCH'}")
    return close


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--target", default="127.0.0.1:8001")
    parser.add_argument("--model", default="bert")
    parser.add_argument("--text", action="append", required=True)
    parser.add_argument("--seq-len", type=int, default=SEQ_LEN)
    parser.add_argument("--validate", action="store_true",
                        help="compare against a local seed-42 random-weight "
                             "reference model")
    parser.add_argument("--device", default="cuda",
                        help="device of the --validate reference model (cuda or cpu)")
    parser.add_argument("--rtol", type=float, default=1e-3)
    parser.add_argument("--atol", type=float, default=1e-3)
    args = parser.parse_args(argv)

    ids, mask = tokenize(args.text, args.seq_len)
    resp = asyncio.run(infer(args.target, args.model, ids, mask))

    out = resp.outputs[0]
    hidden = np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(
        [int(d) for d in out.shape]
    )
    print(f"output {out.name}: shape {hidden.shape}")
    print(f"  mean={hidden.mean():.5f} std={hidden.std():.5f} "
          f"min={hidden.min():.3f} max={hidden.max():.3f}")
    print(f"server timing: total={resp.server_total_ms:.2f}ms "
          f"queue={resp.server_queue_ms:.2f}ms "
          f"inference={resp.server_inference_ms:.2f}ms "
          f"overall={resp.server_overall_ms:.2f}ms")

    if args.validate:
        if not validate_with_reference(hidden, ids, mask, args.rtol, args.atol,
                                       device=args.device):
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
