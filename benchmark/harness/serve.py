"""The system under test: the port's gRPC server (``InferenceServer``), in
this process, on a free localhost port.

It serves the benchmark's weight tree (``params``), warms up as the
server's own start does (one prompt a prefill bucket, one chunked prompt,
which captures the greedy decode block's CUDA graph), and runs its asyncio
loop on a thread of its own until :meth:`Server.stop`.
"""

from __future__ import annotations

import asyncio
import threading
import time


def _quiet_abandoned_streams(loop, context) -> None:
    """The stream handlers of requests cancelled at the end of a run leave
    their token waits pending when the loop closes; say nothing of those."""
    if "Task was destroyed but it is pending" in context.get("message", ""):
        return
    loop.default_exception_handler(context)


class Server:
    def __init__(self, runtime_config: dict, params, device):
        from starpu_inference_server_tpu_torch.grpc.server import InferenceServer
        from starpu_inference_server_tpu_torch.utils.config import parse_config

        self.cfg = parse_config(runtime_config)
        self.server = InferenceServer(self.cfg, device=device, expose_metrics=False,
                                      params=params)
        self.engine = self.server.generation_engine
        self._loop = None
        self._thread = None
        self._ready = threading.Event()
        self._error = None
        self.warm_s = 0.0

    def start(self, timeout_s: float = 1200.0) -> int:
        """Warm up and serve; returns the bound port."""
        def body():
            try:
                asyncio.run(self._serve())
            except BaseException as exc:  # noqa: BLE001 - reported to the caller
                self._error = exc
                self._ready.set()

        t0 = time.monotonic()
        self._thread = threading.Thread(target=body, name="bench-server", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout_s):
            raise TimeoutError("the server did not come up")
        if self._error is not None:
            raise RuntimeError(f"the server failed to start: {self._error!r}") from self._error
        self.warm_s = time.monotonic() - t0
        return self.server.bound_port

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._loop.set_exception_handler(_quiet_abandoned_streams)
        ready = asyncio.Event()
        task = asyncio.ensure_future(self.server.serve(warmup=True, ready_event=ready))
        waiter = asyncio.ensure_future(ready.wait())
        await asyncio.wait({task, waiter}, return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            waiter.cancel()
            task.result()
            return
        self._ready.set()
        await task

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Wait until the engine holds no request (the load generator's
        cancellations have been served); True if it got there."""
        eng = self.engine
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with eng._lock:
                busy = any(s is not None for s in eng._slots) or bool(eng._pending)
            if not busy and eng._prefilling is None and not eng._landings:
                return True
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        """Shut the server down (drain, stop the engine) and join its thread.
        The requests still open are cancelled first, so no stream handler
        waits on one that the stopped engine would never finish."""
        if self.engine is not None and not self.wait_idle(30.0):
            with self.engine._lock:
                open_reqs = [s.request for s in self.engine._slots if s is not None]
                open_reqs += list(self.engine._pending)
            for req in open_reqs:
                req.cancel()
            self.wait_idle(30.0)
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self.server.request_stop)
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            if self._thread.is_alive():
                raise RuntimeError("the server thread did not stop")
        self.engine = None
        self.server = None
