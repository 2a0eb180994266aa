"""Telemetry exposition over HTTP: ``/metrics``, ``/healthz``, ``/slo``.

A deliberately tiny asyncio HTTP/1.1 server (no framework, stdlib only)
that serves three read-only endpoints from a :class:`MetricsRegistry`
and an optional :class:`~repro_torch.obs.slo.SLOTracker`:

- ``GET /metrics`` — Prometheus text exposition (version 0.0.4)
- ``GET /healthz`` — JSON liveness from a caller-supplied callback
- ``GET /slo``     — JSON objective/burn-rate status

The server runs its own event loop on a daemon thread so it composes
with the synchronous service engine (and with tests) without anyone
having to own an asyncio loop. ``port=0`` binds an ephemeral port; the
bound port is readable as ``server.port`` once ``start()`` returns.
A background task re-samples the SLO tracker every
``sample_interval_s`` so burn windows stay populated even when nobody
is scraping.
"""
from __future__ import annotations

import asyncio
import json
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["TelemetryServer", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_JSON = "application/json"
_REASONS = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
            500: "Internal Server Error", 503: "Service Unavailable"}


class TelemetryServer:
    """Serve a registry (and optional SLO tracker) over loopback HTTP."""

    def __init__(self, registry: MetricsRegistry, *,
                 slo=None,
                 health_fn: Optional[Callable[[], Dict[str, object]]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 sample_interval_s: float = 5.0):
        self.registry = registry
        self.slo = slo
        self.health_fn = health_fn
        self.host = host
        self.port = int(port)           # rewritten to the bound port
        self.sample_interval_s = float(sample_interval_s)
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None

    # --------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="obs-telemetry", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10.0):
            raise RuntimeError("telemetry server failed to start in 10s")
        if self._startup_error is not None:
            self._thread.join(timeout=5.0)
            raise self._startup_error
        return self

    def stop(self) -> None:
        loop, thread = self._loop, self._thread
        if loop is not None:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass            # loop already closed: nothing to stop
        if thread is not None:
            thread.join(timeout=10.0)
        self._thread = None
        self._loop = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------- loop thread
    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            server = loop.run_until_complete(asyncio.start_server(
                self._handle, self.host, self.port, limit=1 << 16))
        except OSError as e:
            self._startup_error = e
            self._ready.set()
            loop.close()
            return
        self.port = server.sockets[0].getsockname()[1]
        sampler = None
        if self.slo is not None and self.sample_interval_s > 0:
            sampler = loop.create_task(self._sampler())
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            if sampler is not None:
                sampler.cancel()
            server.close()
            loop.run_until_complete(server.wait_closed())
            # drain cancellations so the loop closes clean
            pending = asyncio.all_tasks(loop)
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.close()

    async def _sampler(self) -> None:
        while True:
            await asyncio.sleep(self.sample_interval_s)
            self.slo.maybe_sample()

    # ---------------------------------------------------------- handling
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            raw = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), timeout=5.0)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            writer.close()
            return
        try:
            request_line = raw.split(b"\r\n", 1)[0].decode(
                "latin-1", "replace")
            parts = request_line.split()
            method = parts[0] if parts else ""
            target = parts[1] if len(parts) > 1 else "/"
            status, ctype, body = self._route(method, target)
            payload = body.encode("utf-8")
            head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n").encode("latin-1")
            writer.write(head + payload)
            await writer.drain()
        except (ConnectionError, OSError):
            pass                # peer went away mid-response: their call
        finally:
            writer.close()

    def _route(self, method: str, target: str) -> Tuple[int, str, str]:
        path = target.split("?", 1)[0]
        if method != "GET":
            return 405, _JSON, json.dumps({"error": "GET only"})
        try:
            if path == "/metrics":
                return (200, PROMETHEUS_CONTENT_TYPE,
                        self.registry.render_prometheus())
            if path == "/healthz":
                return self._healthz()
            if path == "/slo":
                if self.slo is None:
                    return (404, _JSON,
                            json.dumps({"error": "no SLO tracker"}))
                return 200, _JSON, json.dumps(self.slo.status())
        except Exception as e:
            return 500, _JSON, json.dumps({"error": str(e)})
        return 404, _JSON, json.dumps(
            {"error": f"unknown path {path}",
             "paths": ["/metrics", "/healthz", "/slo"]})

    def _healthz(self) -> Tuple[int, str, str]:
        payload: Dict[str, object] = {"status": "ok"}
        if self.health_fn is not None:
            try:
                payload.update(self.health_fn())
            except Exception as e:
                return (500, _JSON,
                        json.dumps({"status": "error", "error": str(e)}))
        status = 200 if payload.get("status") == "ok" else 503
        return status, _JSON, json.dumps(payload)
