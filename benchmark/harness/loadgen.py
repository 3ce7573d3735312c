"""The streaming load generator, run as a process of its own so that its
work never shares an interpreter lock with the server.

    python3 benchmark/harness/loadgen.py < spec.json

The spec names the server's port, the traffic file's contents, the seed and
the run length. Every request goes over ``ModelStreamInfer`` with greedy
decoding and no ``eos_id``, so it streams exactly its ``max_new_tokens``.
A request is complete when its last token has arrived; the client then
sends its next one at once (the stream's own end is read in the
background and never cancelled, so a finished request is never mistaken
for a cancelled one). Every token's arrival is stamped with
``time.monotonic()``, the same clock as the parent's.

It prints JSON lines: ``{"event": "open", "t0": ...}`` when the window
opens (closed loop: once every client has completed one request; open
loop: at the due time of the window's first arrival); with a traced slice
to follow (``slice_s`` > 0), ``{"event": "served", "t": ...}`` once every
request of the window has its first token, after which the traffic goes on
for the slice; then ``{"event": "done", "records": [...]}``.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

import grpc
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the harness
sys.path.insert(1, str(Path(__file__).resolve().parents[2]))  # the port

from harness import traffic as traffic_mod  # noqa: E402


def _pb():
    from starpu_inference_server_tpu_torch.grpc import kserve_v2_pb2

    return kserve_v2_pb2


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class Record:
    __slots__ = ("index", "client", "phase", "prompt_len", "prefix_len", "max_new", "due",
                 "sent", "times", "tokens", "error", "cancelled")

    def __init__(self, req, client: int, due: float):
        self.index = req.index
        self.client = client
        self.phase = req.phase
        self.prompt_len = len(req.prompt)
        self.prefix_len = req.prefix_len
        self.max_new = req.max_new_tokens
        self.due = due
        self.sent = 0.0
        self.times = []
        self.tokens = []
        self.error = None
        self.cancelled = False

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class LoadGen:
    def __init__(self, spec: dict):
        self.spec = spec
        self.pb = _pb()
        self.traffic = spec["traffic"]
        self.requests = traffic_mod.build(self.traffic, spec["seed"], spec["vocab"],
                                          spec["seconds"], spec["tail_s"])
        self.records = []
        self.calls = set()     # streams still open, drained in the background
        self.drains = set()
        self.served_at = None  # when every request of the window had its first token

    def message(self, req):
        msg = self.pb.ModelInferRequest(model_name=self.spec["model"], id=str(req.index))
        t = msg.inputs.add()
        t.name = "input_ids"
        t.datatype = "INT64"
        t.shape.extend([1, len(req.prompt)])
        msg.raw_input_contents.append(np.asarray(req.prompt, np.int64).tobytes())
        msg.parameters["max_new_tokens"].int64_param = int(req.max_new_tokens)
        return msg

    async def one(self, req, client: int, due: float) -> Record:
        rec = Record(req, client, due)
        self.records.append(rec)
        msg = self.message(req)
        rec.sent = time.monotonic()
        call = self.stream(iter([msg]))
        self.calls.add(call)
        try:
            while len(rec.tokens) < rec.max_new:
                resp = await call.read()
                if resp is grpc.aio.EOF:
                    rec.error = f"stream ended after {len(rec.tokens)} of {rec.max_new} tokens"
                    break
                if resp.error_message:
                    rec.error = resp.error_message
                    break
                now = time.monotonic()
                toks = np.frombuffer(resp.infer_response.raw_output_contents[0], np.int32)
                rec.tokens.extend(int(x) for x in toks)
                rec.times.extend([now] * len(toks))
        except asyncio.CancelledError:
            rec.cancelled = True
            call.cancel()
            self.calls.discard(call)
            raise
        except grpc.aio.AioRpcError as exc:
            rec.error = f"{exc.code().name}: {exc.details()}"
        task = asyncio.ensure_future(self._drain(call))
        self.drains.add(task)
        task.add_done_callback(self.drains.discard)
        return rec

    async def _drain(self, call) -> None:
        try:
            while (await call.read()) is not grpc.aio.EOF:
                pass
        except (grpc.aio.AioRpcError, asyncio.CancelledError):
            pass
        finally:
            self.calls.discard(call)

    def _window_of(self, rec, t1: float) -> bool:
        return rec.phase == "window" if self.traffic["loop"] == "open" else rec.sent < t1

    async def _watch_served(self, t1: float) -> None:
        """Emit ``served`` once the window is over and each of its requests
        has a first token (or has ended), so that a traced slice starts only
        after the window's latencies are all taken."""
        while True:
            now = time.monotonic()
            if now >= t1 and all(r.times or r.error or r.cancelled
                                 for r in self.records if self._window_of(r, t1)):
                self.served_at = now
                emit({"event": "served", "t": now})
                return
            await asyncio.sleep(0.02)

    async def closed(self) -> None:
        clients = int(self.traffic["clients"])
        per = [[r for r in self.requests if r.client == c] for c in range(clients)]
        first_done = set()
        window = {"end": None}

        async def client(c):
            i = 0
            while window["end"] is None or time.monotonic() < window["end"]:
                req = per[c][i % len(per[c])]
                i += 1
                rec = await self.one(req, c, 0.0)
                if rec.error is not None:
                    raise RuntimeError(f"request {rec.index}: {rec.error}")
                if c not in first_done:
                    first_done.add(c)
                    if len(first_done) == clients:
                        t0 = time.monotonic()
                        window["t1"] = t0 + self.spec["seconds"]
                        if not self.spec["slice_s"]:
                            window["end"] = window["t1"]
                        emit({"event": "open", "t0": t0})

        tasks = [asyncio.ensure_future(client(c)) for c in range(clients)]
        watcher = None
        while window["end"] is None or time.monotonic() < window["end"]:
            if watcher is None and "t1" in window and self.spec["slice_s"]:
                watcher = asyncio.ensure_future(self._watch_served(window["t1"]))
            if watcher is not None and watcher.done() and window["end"] is None:
                window["end"] = self.served_at + self.spec["slice_s"] + 2.0
            done = [t for t in tasks if t.done()]
            for t in done:
                t.result()  # a failed client fails the run
            if window["end"] is None:
                await asyncio.sleep(0.05)
            else:
                await asyncio.sleep(max(0.0, min(0.05, window["end"] - time.monotonic())))
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def open(self) -> None:
        start = time.monotonic() + 0.5
        t0 = start + traffic_mod.window_start(self.requests)
        emit({"event": "open", "t0": t0})
        watcher = (asyncio.ensure_future(self._watch_served(t0 + self.spec["seconds"]))
                   if self.spec["slice_s"] else None)
        tasks = []
        for req in self.requests:
            due = start + req.due
            delay = due - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append((req, asyncio.ensure_future(self.one(req, 0, due))))
        deadline = t0 + self.spec["seconds"] + float(self.traffic.get("drain_s", 60.0))
        waiting = [t for req, t in tasks if req.phase == "window"]
        if waiting:
            await asyncio.wait(waiting, timeout=max(0.0, deadline - time.monotonic()))
        for _, t in tasks:
            t.cancel()
        await asyncio.gather(*(t for _, t in tasks), return_exceptions=True)
        if watcher is not None:
            watcher.cancel()

    async def run(self) -> None:
        target = f"127.0.0.1:{self.spec['port']}"
        async with grpc.aio.insecure_channel(target) as channel:
            self.stream = channel.stream_stream(
                "/inference.GRPCInferenceService/ModelStreamInfer",
                request_serializer=self.pb.ModelInferRequest.SerializeToString,
                response_deserializer=self.pb.ModelStreamInferResponse.FromString,
            )
            await (self.closed() if self.traffic["loop"] == "closed" else self.open())
            for call in list(self.calls):
                call.cancel()
            if self.drains:
                await asyncio.wait(list(self.drains), timeout=5.0)
        emit({"event": "done", "records": [r.as_dict() for r in self.records]})


def main() -> int:
    spec = json.loads(sys.stdin.read())
    asyncio.run(LoadGen(spec).run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
