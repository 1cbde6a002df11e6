"""Async serving front door: HTTP request queue + SSE token streaming
(port of ``repro/runtime/frontdoor.py``, stdlib ``asyncio`` only).

A stdlib-``asyncio`` HTTP/1.1 server over :class:`ServingEngine`:

  - ``POST /v1/generate`` enters a **bounded admission queue** (queue full
    → 429 before anything is computed; a request whose deadline expires
    while queued → 408, dropped before prefill),
  - one driver task runs the engine through its stepper API
    (``start``/``submit``/``step``/``cancel``): new requests enter and
    cancellations apply between decode steps,
  - each request's tokens stream back as SSE chunks as every decode /
    verify step emits them (:class:`StepEvents`), and
  - a client that disconnects mid-stream has its slot evicted and its KV
    pages freed (``engine.cancel``).

``GET /metrics`` renders the shared :class:`MetricsRegistry`
(``runtime/metrics.py``), sampled once per engine step; the same numbers
land in the final :class:`ServeReport`.

Wire format (one connection per request, ``Connection: close``):

    POST /v1/generate         {"prompt": [ints], "max_new_tokens": N,
                               "deadline_s": S?, "priority": P?,
                               "prefix_embeds"/"audio_embeds": [[floats]]?}
    → 200 text/event-stream   data: {"rid": R, "tokens": [..]}\\n\\n  per
                              engine step, then
                              event: done
                              data: {"rid": R, "n": total}\\n\\n
    → 429 queue full / 408 deadline expired / 400 bad request (JSON body)
    GET /metrics              Prometheus text exposition
    GET /healthz              {"ok": true, ...}

Engine steps are synchronous PyTorch calls; the driver runs them in a
thread-pool executor so the event loop keeps accepting connections and
observing disconnects while a step computes. Only the driver task touches
the engine — handlers talk to it through the queue and the cancel set.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import math
import time
from typing import Dict, List, Optional

from repro_torch.runtime.engine import Request, ServeReport, ServingEngine
from repro_torch.runtime.metrics import MetricsRegistry

__all__ = ["FrontDoor", "QueueSettings", "sse_decode_tokens"]


@dataclasses.dataclass(frozen=True)
class QueueSettings:
    """Admission-queue policy knobs (see ``launch/presets.py`` for the
    per-arch defaults behind ``--queue-depth`` / ``--deadline-s``)."""

    queue_depth: int = 64           # pending requests before 429
    default_deadline_s: Optional[float] = None   # applied when the client
                                                 # sends no deadline_s
    idle_wait_s: float = 0.02       # driver poll interval when idle


class _Pending:
    """One queued request plus its streaming plumbing."""

    __slots__ = ("req", "t_enqueue", "deadline", "events", "gate")

    def __init__(self, req: Request, deadline: Optional[float]):
        self.req = req
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline            # absolute perf_counter() time
        self.events: asyncio.Queue = asyncio.Queue()
        self.gate: asyncio.Future = \
            asyncio.get_running_loop().create_future()
        # gate resolves to "submitted" | "expired" before any body bytes
        # are written, so the status line can still be 408


class FrontDoor:
    """Asyncio HTTP front end over a :class:`ServingEngine`.

    The engine must be constructed with ``admission="priority"`` to honor
    ``priority``/``deadline_s`` ordering (plain FIFO also works — the
    queue semantics are identical, only admission *order* changes).
    """

    def __init__(self, engine: ServingEngine, *,
                 settings: QueueSettings = QueueSettings(),
                 metrics: Optional[MetricsRegistry] = None):
        self.engine = engine
        self.settings = settings
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        engine.metrics = self.metrics
        self.queue: List[_Pending] = []          # admission queue (bounded)
        self._streams: Dict[int, _Pending] = {}  # rid → entry (submitted)
        self._cancels: set = set()               # rids to cancel next step
        self._rids = itertools.count()
        self._server: Optional[asyncio.base_events.Server] = None
        self._driver: Optional[asyncio.Task] = None
        self._running = False
        self.host = self.port = None
        # pre-register the admission series so /metrics shows zeros from
        # the first scrape, not only after the first rejection
        m = self.metrics
        m.counter("frontdoor_admitted_total", "requests accepted into the "
                  "admission queue")
        m.counter("frontdoor_rejected_429_total", "queue-full rejections")
        m.counter("frontdoor_rejected_408_total", "expired-deadline drops")
        m.counter("frontdoor_cancelled_total", "client-disconnect cancels")
        m.gauge("frontdoor_queue_depth", "requests in the admission queue")
        m.histogram("frontdoor_queue_seconds", "enqueue to engine submit")

    # -- lifecycle ---------------------------------------------------------

    async def serve(self, host: str = "127.0.0.1", port: int = 0, *,
                    start_driver: bool = True) -> None:
        """Bind, start accepting, and (unless testing admission alone)
        start the engine driver. ``port=0`` binds an ephemeral port,
        published on ``self.port``."""
        self.engine.start()
        self._running = True
        self._server = await asyncio.start_server(self._handle, host, port)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        if start_driver:
            self.start_driver()

    def start_driver(self) -> None:
        if self._driver is None:
            self._driver = asyncio.create_task(self._drive())

    async def shutdown(self, *, drain: bool = True) -> ServeReport:
        """Stop accepting; optionally finish everything queued/resident,
        then stop the driver and return the final report."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain and self._driver is not None:
            while self.queue or self.engine.has_work() or self._streams:
                await asyncio.sleep(self.settings.idle_wait_s)
        self._running = False
        if self._driver is not None:
            await self._driver
            self._driver = None
        return self.report()

    def report(self) -> ServeReport:
        """The engine's report with the front door's queue economics
        folded in (429/408 counts live here — by definition the engine
        never saw those requests)."""
        return self.engine.report

    # -- driver: the only task that touches the engine ---------------------

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        while self._running:
            self._apply_cancels()
            self._admit_from_queue()
            if not self.engine.has_work():
                await asyncio.sleep(self.settings.idle_wait_s)
                continue
            # run the jitted step off-loop so accepts/disconnects stay live
            ev = await loop.run_in_executor(None, self.engine.step)
            self._dispatch(ev)

    def _apply_cancels(self) -> None:
        report = self.engine.report
        while self._cancels:
            rid = self._cancels.pop()
            entry = self._streams.pop(rid, None)
            queued = next((p for p in self.queue if p.req.rid == rid), None)
            if queued is not None:
                self.queue.remove(queued)
                if not queued.gate.done():
                    queued.gate.set_result("cancelled")
            if self.engine.cancel(rid) or queued is not None:
                self.metrics.counter("frontdoor_cancelled_total").inc()
                if queued is not None and rid not in report.cancelled:
                    report.cancelled[rid] = []
            if entry is not None:
                entry.events.put_nowait(("cancelled", None))
        self.metrics.gauge("frontdoor_queue_depth").set(len(self.queue))

    def _admit_from_queue(self) -> None:
        """Feed queued requests to the engine; expired deadlines are
        dropped here — before prefill, before a slot, before any compute —
        and their clients get the 408. Only as many requests as could
        occupy a slot next step move over; the rest *stay in the front-door
        queue*, where their deadlines keep being checked every driver
        iteration (the engine's internal queue never grows beyond the slot
        pool, so queue depth is observable in one place)."""
        report = self.engine.report
        now = time.perf_counter()
        still: List[_Pending] = []
        for p in self.queue:
            if p.deadline is not None and now > p.deadline:
                report.rejected_408 += 1
                self.metrics.counter("frontdoor_rejected_408_total").inc()
                if not p.gate.done():
                    p.gate.set_result("expired")
            else:
                still.append(p)
        free = sum(1 for s in self.engine._slots if s is None)
        budget = max(0, free - len(self.engine._waiting))
        if self.engine.admission == "priority":
            still.sort(key=lambda p: (
                -(p.req.priority or 0),
                p.deadline if p.deadline is not None else math.inf,
                p.req.rid))
        for p in still[:budget]:
            wait = now - p.t_enqueue
            report.queue_wait[p.req.rid] = wait
            self.metrics.histogram("frontdoor_queue_seconds").observe(wait)
            self.engine.submit(p.req)
            self._streams[p.req.rid] = p
            if not p.gate.done():
                p.gate.set_result("submitted")
        self.queue[:] = still[budget:]
        self.metrics.gauge("frontdoor_queue_depth").set(len(self.queue))

    def _dispatch(self, ev) -> None:
        """Fan one step's events out to the per-request streams."""
        for rid, toks in ev.emitted.items():
            entry = self._streams.get(rid)
            if entry is not None:
                entry.events.put_nowait(("tokens", list(toks)))
        for rid in ev.finished:
            entry = self._streams.pop(rid, None)
            if entry is not None:
                entry.events.put_nowait(("done", None))

    # -- HTTP --------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, headers = await _read_head(reader)
            if method is None:
                return
            if method == "GET" and path == "/metrics":
                await _respond(writer, 200, self.metrics.render(),
                               ctype="text/plain; version=0.0.4")
            elif method == "GET" and path == "/healthz":
                await _respond_json(writer, 200, {
                    "ok": True, "queued": len(self.queue),
                    "resident": sum(1 for s in self.engine._slots
                                    if s is not None)})
            elif method == "POST" and path == "/v1/generate":
                body = await reader.readexactly(
                    int(headers.get("content-length", 0)))
                await self._generate(reader, writer, body)
            else:
                await _respond_json(writer, 404, {"error": "not found"})
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _generate(self, reader, writer, body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = spec["prompt"]
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError("prompt must be a non-empty int list")
            max_new = int(spec.get("max_new_tokens",
                                   self.engine.max_new_tokens))
            deadline_s = spec.get("deadline_s",
                                  self.settings.default_deadline_s)
            priority = int(spec.get("priority", 0))
            prefix_embeds = spec.get("prefix_embeds")
            audio_embeds = spec.get("audio_embeds")
            cfg = self.engine.cfg
            if prefix_embeds is not None:
                # shape-check here so a ragged payload is a 400, not a
                # dead driver task
                if not cfg.vision_prefix:
                    raise ValueError(f"{cfg.name} takes no prefix_embeds")
                if (len(prefix_embeds) != cfg.vision_prefix or any(
                        len(r) != cfg.d_model for r in prefix_embeds)):
                    raise ValueError(
                        f"prefix_embeds must be {cfg.vision_prefix} x "
                        f"{cfg.d_model}")
            if audio_embeds is not None:
                if cfg.family != "encdec":
                    raise ValueError(f"{cfg.name} takes no audio_embeds")
                if (len(audio_embeds) != cfg.encoder_seq or any(
                        len(r) != cfg.d_model for r in audio_embeds)):
                    raise ValueError(
                        f"audio_embeds must be {cfg.encoder_seq} x "
                        f"{cfg.d_model}")
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            await _respond_json(writer, 400, {"error": f"bad request: {e}"})
            return
        if len(prompt) > self.engine.max_prompt_len \
                or not 1 <= max_new <= self.engine.max_new_tokens:
            await _respond_json(writer, 400, {
                "error": f"prompt_len <= {self.engine.max_prompt_len} and "
                         f"1 <= max_new_tokens <= "
                         f"{self.engine.max_new_tokens} required"})
            return

        report = self.engine.report
        # -- SLO-aware admission: bounded queue, deadline-checked ----------
        if len(self.queue) >= self.settings.queue_depth:
            report.rejected_429 += 1
            self.metrics.counter("frontdoor_rejected_429_total").inc()
            await _respond_json(writer, 429, {
                "error": f"admission queue full "
                         f"({self.settings.queue_depth} pending)"})
            return
        if deadline_s is not None and deadline_s <= 0:
            report.rejected_408 += 1
            self.metrics.counter("frontdoor_rejected_408_total").inc()
            await _respond_json(writer, 408, {"error": "deadline expired"})
            return
        rid = next(self._rids)
        req = Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new,
                      deadline_s=deadline_s, priority=priority,
                      prefix_embeds=prefix_embeds, audio_embeds=audio_embeds)
        entry = _Pending(req, None if deadline_s is None
                         else time.perf_counter() + deadline_s)
        self.queue.append(entry)
        self.metrics.counter("frontdoor_admitted_total").inc()
        self.metrics.gauge("frontdoor_queue_depth").set(len(self.queue))
        report.peak_queue_depth = max(report.peak_queue_depth,
                                      len(self.queue))

        # status line waits for the queue verdict: 408 must be a real 408,
        # not a half-started event stream
        outcome = await entry.gate
        if outcome == "expired":
            await _respond_json(writer, 408, {
                "error": "deadline expired in queue"})
            return
        if outcome == "cancelled":
            return

        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        watch = asyncio.create_task(_watch_eof(reader))
        n = 0
        try:
            while True:
                getter = asyncio.create_task(entry.events.get())
                done, _ = await asyncio.wait(
                    {getter, watch}, return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:          # client went away first
                    getter.cancel()
                    self._cancels.add(rid)
                    return
                kind, payload = getter.result()
                if kind == "tokens":
                    n += len(payload)
                    writer.write(_sse({"rid": rid, "tokens": payload}))
                    await writer.drain()
                elif kind == "done":
                    writer.write(b"event: done\r\ndata: " +
                                 json.dumps({"rid": rid, "n": n}).encode() +
                                 b"\r\n\r\n")
                    await writer.drain()
                    return
                else:                           # cancelled server-side
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._cancels.add(rid)              # mid-stream disconnect
        finally:
            watch.cancel()


# -- wire helpers -----------------------------------------------------------

_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           408: "Request Timeout", 429: "Too Many Requests"}


async def _read_head(reader):
    """Parse request line + headers (no pipelining; one request/conn)."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 3:
        return None, None, None
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return parts[0].upper(), parts[1], headers


async def _respond(writer, status: int, body: str, *,
                   ctype: str = "text/plain") -> None:
    data = body.encode()
    writer.write((f"HTTP/1.1 {status} {_STATUS.get(status, '')}\r\n"
                  f"Content-Type: {ctype}\r\n"
                  f"Content-Length: {len(data)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + data)
    await writer.drain()


async def _respond_json(writer, status: int, obj: dict) -> None:
    await _respond(writer, status, json.dumps(obj),
                   ctype="application/json")


def _sse(obj: dict) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\r\n\r\n"


async def _watch_eof(reader) -> None:
    """Resolve when the client half closes (disconnect detection while the
    server is the only side writing)."""
    try:
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                return
    except (ConnectionResetError, OSError):
        return


def sse_decode_tokens(payload: bytes) -> List[int]:
    """Client-side helper (tests, benches, the serve CLI's HTTP mode):
    concatenate the ``tokens`` arrays out of a raw SSE response body."""
    toks: List[int] = []
    for block in payload.split(b"\r\n\r\n"):
        for line in block.split(b"\r\n"):
            if line.startswith(b"data: "):
                try:
                    obj = json.loads(line[len(b"data: "):])
                except json.JSONDecodeError:
                    continue
                if isinstance(obj, dict) and "tokens" in obj:
                    toks.extend(obj["tokens"])
    return toks
