"""Async gRPC load-generator client.

Counterpart of ``starpu_inference_server_tpu/clients/client.py``, with the
same flags, defaults and summary schema. It speaks the KServe-v2 protocol
only, so it drives a server of either package. Run it as

    python -m starpu_inference_server_tpu_torch.clients.client --model resnet152_perf \
        --input input:3x224x224:FP32 --schedule ci/perf/ci_perf_resnet_smoke.csv --validate

or, against a decoder, with ``--generate N`` (``--stream`` for time to
first token). ``GenerationClient`` also keeps the tokens each request
received (``tokens_by_request``), which the summary leaves out.

Reference counterpart: src/grpc/client/{client_main.cpp,
inference_client.*} — an async ModelInfer generator driven either by a
fixed delay or a **schedule replay** CSV of ``delta_us,repeat[,input_id]``
segments over a pool of 5 pre-generated input tensors
(docs/client_guide.md:104-132), producing a summary JSON with
``requests{sent,handled,rejected}``, ``throughput_rps`` and
mean/p50/p85/p95/p100 for the roundtrip and all server-side phases
(inference_client.hpp:30-67; write_summary_json
inference_client.cpp:277-360). The perf CI gates
(scripts/check_perf_summary.py / compare_perf_summaries.py) consume this
exact schema.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import grpc
import numpy as np

from ..utils.clock import wall_ms
from ..utils.config import TensorSpec
from ..utils.dtypes import canonical_dtype_name, numpy_dtype
from ..utils.input_generator import generate_inputs
from ..utils.latency_statistics import summarize
from . import _pb  # re-exported generated module

INPUT_POOL_SIZE = 5  # reference pre-generates 5 tensors

PHASE_FIELDS = (
    ("server_overall", "server_overall_ms"),
    ("preprocess", "server_preprocess_ms"),
    ("queue", "server_queue_ms"),
    ("batching", "server_batch_ms"),
    ("submit", "server_submit_ms"),
    ("scheduling", "server_scheduling_ms"),
    ("codelet", "server_codelet_ms"),
    ("inference", "server_inference_ms"),
    ("callback", "server_callback_ms"),
    ("postprocess", "server_postprocess_ms"),
    ("job_total", "server_total_ms"),
)


@dataclasses.dataclass
class LatencySample:
    roundtrip_ms: float
    request_ms: float     # client send -> server receive
    response_ms: float    # server send -> client receive
    phases: Dict[str, float]


@dataclasses.dataclass
class ScheduleSegment:
    delta_us: int
    repeat: int
    input_id: Optional[int] = None


def parse_input_arg(arg: str) -> TensorSpec:
    """--input name:dxdxd:dtype, e.g. input:3x224x224:FP32."""
    parts = arg.split(":")
    if len(parts) != 3:
        raise ValueError(f"--input must be name:shape:dtype, got {arg!r}")
    name, shape_s, dtype = parts
    dims = tuple(int(d) for d in shape_s.lower().split("x"))
    return TensorSpec(name=name, dims=dims, dtype=canonical_dtype_name(dtype))


def load_schedule(path: str) -> List[ScheduleSegment]:
    """CSV rows ``delta_us,repeat[,input_id]``
    (reference: docs/client_guide.md:104-132)."""
    segments = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            segments.append(
                ScheduleSegment(
                    delta_us=int(parts[0]),
                    repeat=int(parts[1]),
                    input_id=int(parts[2]) if len(parts) > 2 else None,
                )
            )
    return segments


class InferenceClient:
    def __init__(
        self,
        target: str,
        model_name: str,
        specs: Sequence[TensorSpec],
        batch: int = 1,
        seed: int = 7,
        max_message_bytes: int = 256 * 1024 * 1024,
        validate: bool = False,
        expected_fn=None,
        rtol: float = 2e-2,
        atol: float = 2e-2,
    ):
        """``validate=True`` checks every response's bytes, not just its
        latency (reference: the C++ client verifies each response against
        locally computed expected outputs and the load loop fails on
        mismatch — src/grpc/client/inference_client.cpp). Expected
        outputs come from ``expected_fn(inputs)->outputs`` when given
        (analytic models), otherwise from a low-load priming pass per
        pool input (self-consistency: catches batch-slicing corruption,
        stale staging buffers, and nondeterminism under load — the
        failure modes a latency-only perf run would silently serve)."""
        self.target = target
        self.model_name = model_name
        self.specs = list(specs)
        self.batch = batch
        self.validate = bool(validate)
        self.expected_fn = expected_fn
        self.rtol, self.atol = rtol, atol
        self.expected: Dict[int, Dict[str, np.ndarray]] = {}
        self.validated = 0
        self.validation_failures = 0
        self.first_mismatch: Optional[str] = None
        options = [
            ("grpc.max_receive_message_length", max_message_bytes),
            ("grpc.max_send_message_length", max_message_bytes),
        ]
        self._channel = grpc.aio.insecure_channel(target, options=options)
        self._infer = self._channel.unary_unary(
            "/inference.GRPCInferenceService/ModelInfer",
            request_serializer=_pb.ModelInferRequest.SerializeToString,
            response_deserializer=_pb.ModelInferResponse.FromString,
        )
        self._live = self._channel.unary_unary(
            "/inference.GRPCInferenceService/ServerLive",
            request_serializer=_pb.ServerLiveRequest.SerializeToString,
            response_deserializer=_pb.ServerLiveResponse.FromString,
        )
        self._ready = self._channel.unary_unary(
            "/inference.GRPCInferenceService/ServerReady",
            request_serializer=_pb.ServerReadyRequest.SerializeToString,
            response_deserializer=_pb.ServerReadyResponse.FromString,
        )
        rng = np.random.default_rng(seed)
        self.input_pool = [
            generate_inputs(self.specs, batch, rng) for _ in range(INPUT_POOL_SIZE)
        ]
        self.samples: List[LatencySample] = []
        self.sent = 0
        self.handled = 0
        self.rejected = 0
        self.errors = 0

    async def wait_ready(self, timeout_s: float = 300.0) -> None:
        # default generous: server warmup compiles one executable per
        # (device, bucket) before flipping ready
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                live = await self._live(_pb.ServerLiveRequest(), timeout=2.0)
                ready = await self._ready(_pb.ServerReadyRequest(), timeout=2.0)
                if live.live and ready.ready:
                    return
            except grpc.aio.AioRpcError:
                pass
            await asyncio.sleep(0.2)
        raise TimeoutError(f"server at {self.target} not ready in {timeout_s}s")

    @staticmethod
    def parse_outputs(resp) -> Dict[str, np.ndarray]:
        """Decode a ModelInferResponse's raw output tensors."""
        out = {}
        for i, t in enumerate(resp.outputs):
            arr = np.frombuffer(
                resp.raw_output_contents[i], numpy_dtype(t.datatype)
            ).reshape(tuple(t.shape))
            out[t.name] = arr
        return out

    async def prime_expected(self) -> None:
        """Record the expected outputs for every pool input: analytic
        when ``expected_fn`` is set, else one uncontended server pass per
        input (self-consistency oracle)."""
        for input_id in range(INPUT_POOL_SIZE):
            inputs = self.input_pool[input_id]
            if self.expected_fn is not None:
                self.expected[input_id] = self.expected_fn(inputs)
            else:
                resp = await self._infer(
                    self._build_request(input_id, f"prime-{input_id}")
                )
                self.expected[input_id] = self.parse_outputs(resp)

    def _check_response(self, input_id: int, resp) -> None:
        want = self.expected.get(input_id % INPUT_POOL_SIZE)
        if want is None:
            return
        self.validated += 1
        got = self.parse_outputs(resp)
        for name, ref in want.items():
            arr = got.get(name)
            ok = (
                arr is not None
                and arr.shape == ref.shape
                and np.allclose(
                    arr.astype(np.float64), ref.astype(np.float64),
                    rtol=self.rtol, atol=self.atol,
                )
            )
            if not ok:
                self.validation_failures += 1
                if self.first_mismatch is None:
                    detail = (
                        "missing/shape" if arr is None or arr.shape != ref.shape
                        else f"maxdiff={np.abs(arr - ref).max():.3e}"
                    )
                    self.first_mismatch = (
                        f"{resp.id}: output {name!r} mismatch ({detail})"
                    )
                return

    def _build_request(self, input_id: int, request_id: str) -> _pb.ModelInferRequest:
        req = _pb.ModelInferRequest(model_name=self.model_name, id=request_id)
        data = self.input_pool[input_id % INPUT_POOL_SIZE]
        for spec in self.specs:
            arr = data[spec.name]
            t = req.inputs.add()
            t.name = spec.name
            t.datatype = spec.dtype
            t.shape.extend(arr.shape)
            req.raw_input_contents.append(arr.tobytes())
        req.client_send_ms = int(wall_ms())
        return req

    async def _one_request(self, input_id: int, rid: int) -> None:
        req = self._build_request(input_id, f"req-{rid}")
        t0 = wall_ms()
        self.sent += 1
        try:
            resp = await self._infer(req)
        except grpc.aio.AioRpcError as exc:
            if exc.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                self.rejected += 1
            else:
                self.errors += 1
            return
        t1 = wall_ms()
        if self.validate:
            self._check_response(input_id, resp)
        phases = {key: getattr(resp, field) for key, field in PHASE_FIELDS}
        self.samples.append(
            LatencySample(
                roundtrip_ms=t1 - t0,
                request_ms=max(0.0, resp.server_receive_ms - req.client_send_ms),
                response_ms=max(0.0, t1 - resp.server_send_ms),
                phases=phases,
            )
        )
        self.handled += 1

    async def run_fixed(self, count: int, delay_us: int) -> float:
        """count requests at a fixed gap; returns elapsed seconds."""
        start = time.monotonic()
        tasks = []
        next_at = start
        for i in range(count):
            now = time.monotonic()
            if now < next_at:
                await asyncio.sleep(next_at - now)
            tasks.append(asyncio.ensure_future(self._one_request(i, i)))
            next_at += delay_us / 1e6
        await asyncio.gather(*tasks)
        return time.monotonic() - start

    async def run_schedule(self, segments: Sequence[ScheduleSegment]) -> float:
        """Replay a recorded arrival schedule
        (reference: client_main.cpp:31-48)."""
        start = time.monotonic()
        tasks = []
        rid = 0
        next_at = start
        for seg in segments:
            for _ in range(seg.repeat):
                now = time.monotonic()
                if now < next_at:
                    await asyncio.sleep(next_at - now)
                input_id = seg.input_id if seg.input_id is not None else rid
                tasks.append(
                    asyncio.ensure_future(self._one_request(input_id, rid))
                )
                rid += 1
                next_at += seg.delta_us / 1e6
        await asyncio.gather(*tasks)
        return time.monotonic() - start

    def summary(self, elapsed_s: float) -> Dict:
        """Summary JSON matching the reference schema
        (write_summary_json, inference_client.cpp:277-360)."""
        latency: Dict[str, Dict[str, float]] = {
            "roundtrip": summarize([s.roundtrip_ms for s in self.samples]),
            "request": summarize([s.request_ms for s in self.samples]),
            "response": summarize([s.response_ms for s in self.samples]),
            "client_overhead": summarize(
                [
                    max(0.0, s.roundtrip_ms - s.phases.get("server_overall", 0.0))
                    for s in self.samples
                ]
            ),
        }
        for key, _field in PHASE_FIELDS:
            latency[key] = summarize([s.phases[key] for s in self.samples])
        out = {
            "requests": {
                "sent": self.sent,
                "handled": self.handled,
                "rejected": self.rejected,
                "errors": self.errors,
            },
            "throughput_rps": self.handled / elapsed_s if elapsed_s > 0 else 0.0,
            "elapsed_s": elapsed_s,
            "latency_ms": latency,
        }
        if self.validate:
            out["validation"] = {
                "checked": self.validated,
                "failures": self.validation_failures,
            }
            if self.first_mismatch:
                out["validation"]["first_mismatch"] = self.first_mismatch
        return out

    async def close(self) -> None:
        await self._channel.close()


def pooled_prompts(prompt_len: int, vocab: int = 32000, seed: int = 7,
                   shared_prefix: int = 0) -> List[np.ndarray]:
    """The ``INPUT_POOL_SIZE`` prompts a ``GenerationClient`` cycles
    through, request ``rid`` sending prompt ``rid % INPUT_POOL_SIZE``:
    ``shared_prefix`` tokens common to all, then random ids up to
    ``prompt_len`` (at least one), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, (shared_prefix,), np.int64)
    return [
        np.concatenate(
            [prefix, rng.integers(1, vocab, (max(1, prompt_len - shared_prefix),), np.int64)]
        )
        for _ in range(INPUT_POOL_SIZE)
    ]


class GenerationClient:
    """Decoder load generator: ``count`` generation requests at bounded
    concurrency, unary (ModelInfer) or streaming (ModelStreamInfer, which
    also measures time-to-first-token). Net-new surface — the reference
    serves no decoders; the summary schema extends the reference's with a
    ``generation`` block (tokens/s, TTFT percentiles)."""

    def __init__(
        self,
        target: str,
        model_name: str,
        prompt_len: int,
        max_new_tokens: int,
        vocab: int = 32000,
        seed: int = 7,
        shared_prefix: int = 0,
    ):
        self.model_name = model_name
        self.max_new_tokens = max_new_tokens
        self._channel = grpc.aio.insecure_channel(target)
        self._infer = self._channel.unary_unary(
            "/inference.GRPCInferenceService/ModelInfer",
            request_serializer=_pb.ModelInferRequest.SerializeToString,
            response_deserializer=_pb.ModelInferResponse.FromString,
        )
        self._stream = self._channel.stream_stream(
            "/inference.GRPCInferenceService/ModelStreamInfer",
            request_serializer=_pb.ModelInferRequest.SerializeToString,
            response_deserializer=_pb.ModelStreamInferResponse.FromString,
        )
        self.prompts = pooled_prompts(prompt_len, vocab, seed, shared_prefix)
        self.sent = 0
        self.handled = 0
        self.rejected = 0
        self.errors = 0
        self.tokens = 0
        self.roundtrips: List[float] = []
        self.ttfts: List[float] = []
        self.tokens_by_request: Dict[int, List[int]] = {}

    def _request(self, rid: int) -> _pb.ModelInferRequest:
        prompt = self.prompts[rid % INPUT_POOL_SIZE]
        req = _pb.ModelInferRequest(model_name=self.model_name, id=f"gen-{rid}")
        t = req.inputs.add()
        t.name = "input_ids"
        t.datatype = "INT64"
        t.shape.extend([1, len(prompt)])
        req.raw_input_contents.append(prompt.tobytes())
        req.parameters["max_new_tokens"].int64_param = self.max_new_tokens
        return req

    async def _one(self, rid: int, stream: bool) -> None:
        self.sent += 1
        t0 = wall_ms()
        try:
            if stream:
                first = None
                got: List[int] = []
                async for msg in self._stream(iter([self._request(rid)])):
                    if msg.error_message:
                        self.errors += 1
                        return
                    if first is None:
                        first = wall_ms()
                    got += _tokens(msg.infer_response)
                if first is not None:
                    self.ttfts.append(first - t0)
            else:
                got = _tokens(await self._infer(self._request(rid)))
            self.tokens += len(got)
            self.tokens_by_request[rid] = got
        except grpc.aio.AioRpcError as exc:
            if exc.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                self.rejected += 1
            else:
                self.errors += 1
            return
        self.roundtrips.append(wall_ms() - t0)
        self.handled += 1

    async def run(self, count: int, concurrency: int, stream: bool) -> float:
        start = time.monotonic()
        sem = asyncio.Semaphore(max(1, concurrency))

        async def worker(rid):
            async with sem:
                await self._one(rid, stream)

        await asyncio.gather(*(worker(i) for i in range(count)))
        return time.monotonic() - start

    def summary(self, elapsed_s: float) -> Dict:
        out = {
            "requests": {
                "sent": self.sent,
                "handled": self.handled,
                "rejected": self.rejected,
                "errors": self.errors,
            },
            "throughput_rps": self.handled / elapsed_s if elapsed_s else 0.0,
            "elapsed_s": elapsed_s,
            "latency_ms": {"roundtrip": summarize(self.roundtrips)},
            "generation": {
                "tokens_total": self.tokens,
                "tokens_per_s": self.tokens / elapsed_s if elapsed_s else 0.0,
                "tokens_per_request": (
                    self.tokens / self.handled if self.handled else 0.0
                ),
            },
        }
        if self.ttfts:
            out["generation"]["ttft_ms"] = summarize(self.ttfts)
        return out

    async def close(self) -> None:
        await self._channel.close()


def _tokens(resp) -> List[int]:
    """The token ids of a generation response (INT32 ``raw_output_contents[0]``)."""
    return np.frombuffer(resp.raw_output_contents[0], np.int32).tolist()


async def _amain(args) -> Dict:
    if args.generate > 0:
        probe = InferenceClient(
            args.target, args.model,
            [TensorSpec("input_ids", (args.prompt_len,), "INT64")],
            seed=args.seed,
        )
        await probe.wait_ready(timeout_s=args.ready_timeout_s)
        await probe.close()
        gen = GenerationClient(
            args.target, args.model, prompt_len=args.prompt_len,
            max_new_tokens=args.generate, vocab=args.vocab, seed=args.seed,
            shared_prefix=args.shared_prefix,
        )
        elapsed = await gen.run(
            args.request_number, args.concurrency, args.stream
        )
        await gen.close()
        return gen.summary(elapsed)
    specs = [parse_input_arg(a) for a in args.input]
    # analytic validation oracles for the synthetic serving models; real
    # models fall back to the priming-pass self-consistency oracle
    expected_fn = None
    if args.validate and args.model == "add_one":
        expected_fn = lambda inputs: {  # noqa: E731
            "output": next(iter(inputs.values())) + 1.0
        }
    elif args.validate and args.model == "identity":
        expected_fn = lambda inputs: {  # noqa: E731
            "output": next(iter(inputs.values()))
        }
    client = InferenceClient(
        args.target, args.model, specs, batch=args.batch, seed=args.seed,
        validate=args.validate, expected_fn=expected_fn,
        rtol=args.validate_rtol, atol=args.validate_atol,
    )
    await client.wait_ready(timeout_s=args.ready_timeout_s)
    if args.validate:
        await client.prime_expected()
    if args.schedule:
        elapsed = await client.run_schedule(load_schedule(args.schedule))
    else:
        elapsed = await client.run_fixed(args.request_number, args.delay_us)
    await client.close()
    return client.summary(elapsed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="inference load client")
    parser.add_argument("--target", default="127.0.0.1:8001")
    parser.add_argument("--model", required=True)
    parser.add_argument(
        "--input", action="append", default=[],
        help="name:shape:dtype, e.g. input:3x224x224:FP32",
    )
    parser.add_argument("--request-number", type=int, default=100)
    parser.add_argument("--delay-us", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--schedule", help="CSV delta_us,repeat[,input_id]")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--ready-timeout-s", type=float, default=300.0)
    parser.add_argument("--summary-json", help="write summary JSON here")
    parser.add_argument("--validate", action="store_true",
                        help="check every response's bytes against "
                             "expected outputs (analytic for add_one/"
                             "identity, priming-pass oracle otherwise); "
                             "nonzero exit on any mismatch")
    # defaults absorb bf16 staging/compute precision (~4e-3 relative);
    # slicing/corruption bugs produce diffs orders of magnitude larger
    parser.add_argument("--validate-rtol", type=float, default=2e-2)
    parser.add_argument("--validate-atol", type=float, default=2e-2)
    # decoder generation load mode (net-new; reference has no decoders)
    parser.add_argument("--generate", type=int, default=0,
                        help="max_new_tokens (> 0 switches to generation mode)")
    parser.add_argument("--prompt-len", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--stream", action="store_true",
                        help="use ModelStreamInfer and report TTFT")
    parser.add_argument("--shared-prefix", type=int, default=0,
                        help="prompt tokens shared across the pool "
                             "(exercises the server's prefix cache)")
    args = parser.parse_args(argv)
    if not args.generate and not args.input:
        parser.error("--input is required (or use --generate)")

    summary = asyncio.run(_amain(args))
    text = json.dumps(summary, indent=2)
    print(text)
    if args.summary_json:
        with open(args.summary_json, "w") as fh:
            fh.write(text)
    failures = summary.get("validation", {}).get("failures", 0)
    if failures:
        print(f"[client] VALIDATION FAILED: {failures} mismatched "
              "responses", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
