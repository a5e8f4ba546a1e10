"""The serving front end: HTTP/1.1 with server-sent events over the
engine (port of ``repro.serve.server``; stdlib ``asyncio`` only, the
reference's wire format).

* :class:`AsyncServeEngine` owns one engine on one event loop. A step
  task runs ``engine.step()`` once a loop turn while the engine has work
  and parks when it drains; the scheduler's ``on_token`` hook hands each
  recorded token to its request's ``asyncio.Queue``, and a stream takes
  every token queued for it at each wake-up, so a client's tokens trail
  the step that sampled them by a fixed few turns (one token per wake-up
  would fall a step further behind every few steps). Submission passes
  the engine's overload gate (``ShedError``) and is refused while
  draining (:class:`DrainingError`).
* :class:`ServeHTTPServer` answers

  - ``POST /v1/generate``, body ``{"prompt": [ids], "max_new_tokens": n,
    "temperature": t, "top_p": p, "top_k": k, "seed": s}`` (the sampling
    fields optional, else the engine's defaults): an SSE stream of
    ``{"request_id": id}``, then ``{"token": t, "index": i}`` a token,
    then ``{"done": true, "request_id": id, "tokens": [...]}`` (or
    ``"cancelled": true``). 429 with ``Retry-After`` on a shed, 503 while
    draining, 400 on a malformed body;
  - ``POST /v1/cancel``, body ``{"request_id": id}``;
  - ``GET /v1/health``: the overload stats, ``queue_depth`` and
    ``draining``;
  - ``POST /v1/drain``: stop admitting, answer once every resident
    request has finished.

  A client that hangs up is found two ways, the socket's EOF while its
  stream waits and a failed write, and either cancels its request, so
  its slot and pages go back the same step.

A step is synchronous device work; it runs inline between loop turns,
so tokens, submissions, cancels and hang-ups interleave at step
granularity. Steps serialize on the one device anyway, so a thread would
add jitter and no parallelism.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional

import numpy as np

from .overload import ShedError
from .sampling import SamplingParams

log = logging.getLogger(__name__)

#: the queue items that end a stream: its request was cancelled, or an
#: engine step failed
_CANCELLED = object()
_FAILED = object()


class StepFailed(RuntimeError):
    """An engine step raised while the request was streaming; the step's
    own exception comes out of :meth:`AsyncServeEngine.drain`."""


class DrainingError(RuntimeError):
    """A submission refused because the server is draining (HTTP 503)."""


class AsyncServeEngine:
    """Async facade over one ``ContinuousBatchingEngine``: all submissions,
    cancels and steps of the engine go through it, on one event loop."""

    def __init__(self, engine):
        self.engine = engine
        engine.scheduler.on_token = self._on_token
        self._queues: Dict[int, asyncio.Queue] = {}
        self._step_task: Optional[asyncio.Task] = None
        self.draining = False
        self._idle = asyncio.Event()
        self._idle.set()

    def _on_token(self, req, token: int, finished: bool) -> None:
        queue = self._queues.get(req.id)
        if queue is not None:
            queue.put_nowait((token, finished))

    def submit(self, prompt, max_new_tokens: int,
               sampling_params: Optional[SamplingParams] = None) -> int:
        """Queue one request and return its id (its tokens come from
        :meth:`token_batches`). Raises :class:`DrainingError` while draining and
        passes on the engine's ``ShedError`` and ``ValueError``."""
        if self.draining:
            raise DrainingError("server is draining, not accepting work")
        rid = self.engine.submit(np.asarray(prompt, np.int32), max_new_tokens,
                                 sampling_params=sampling_params)
        self._queues[rid] = asyncio.Queue()
        self._kick()
        return rid

    async def token_batches(self, request_id: int):
        """Yield lists of ``(token, finished)`` of one request: at each
        wake-up, every token queued for it so far, so that a consumer that
        takes one loop turn a wake-up still keeps up with a step a turn.
        Ends after the finishing token; a cancelled request's just ends."""
        queue = self._queues.get(request_id)
        if queue is None:
            raise KeyError(f"unknown request id {request_id}")
        try:
            while True:
                items = [await queue.get()]
                while not queue.empty():
                    items.append(queue.get_nowait())
                ends = [i for i, item in enumerate(items)
                        if item is _CANCELLED or item is _FAILED]
                cut = ends[0] if ends else len(items)
                if cut:
                    yield items[:cut]
                if ends and items[cut] is _FAILED:
                    raise StepFailed(f"request {request_id}: an engine "
                                     "step failed")
                if ends or items[-1][1]:
                    return
        finally:
            self._queues.pop(request_id, None)

    def cancel(self, request_id: int) -> bool:
        """Cancel a request in the engine and end its stream. True if it
        was still live."""
        found = self.engine.cancel(request_id)
        # drop the entry now: a hung-up client's stream may never resume
        # to clean up; a live stream still holds the queue and sees the end
        queue = self._queues.pop(request_id, None)
        if queue is not None:
            queue.put_nowait(_CANCELLED)
        return found

    async def drain(self) -> None:
        """Refuse new work, then wait until every resident request has
        finished (graceful shutdown). Raises what a failed step raised."""
        self.draining = True
        await self._idle.wait()
        task = self._step_task
        if task is not None and task.done() and not task.cancelled() \
                and task.exception() is not None:
            raise task.exception()

    def _kick(self) -> None:
        if self._step_task is None or self._step_task.done():
            self._idle.clear()
            self._step_task = asyncio.get_running_loop().create_task(
                self._run_steps())

    async def _run_steps(self) -> None:
        engine = self.engine
        try:
            while engine.scheduler.has_work:
                engine.step()
                # streamed results live in their queues: keep the batch
                # API's list of finished requests from growing
                engine.scheduler.finished.clear()
                await asyncio.sleep(0)  # one loop turn a step
        except Exception:
            log.exception("engine step failed: ending every stream")
            for queue in self._queues.values():
                queue.put_nowait(_FAILED)
            raise
        finally:
            self._idle.set()


# ---------------------------------------------------------------------------
# HTTP/SSE
# ---------------------------------------------------------------------------

_SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n\r\n")

_HANGUP = (ConnectionResetError, BrokenPipeError)


def _json_response(status: str, payload: dict,
                   extra_headers: str = "") -> bytes:
    body = json.dumps(payload).encode()
    return (f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n{extra_headers}"
            f"Connection: close\r\n\r\n").encode() + body


def _sse_event(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


def _parse_sampling(body: dict) -> Optional[SamplingParams]:
    """The request's own sampling, or None for the engine's defaults."""
    if not any(k in body for k in ("temperature", "top_p", "top_k", "seed")):
        return None
    seed = body.get("seed")
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        seed=None if seed is None else int(seed)).validate()


class ServeHTTPServer:
    """The HTTP/1.1 + SSE routes of the module docstring over an
    :class:`AsyncServeEngine`; ``port`` 0 binds an ephemeral port, which
    :meth:`start` writes back."""

    def __init__(self, async_engine: AsyncServeEngine,
                 host: str = "127.0.0.1", port: int = 8000):
        self.engine = async_engine
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        if self._server is None:
            raise RuntimeError("call start() first")
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await self._read_request(reader)
            await self._route(method, path, body, reader, writer)
            await writer.drain()
        except (*_HANGUP, asyncio.IncompleteReadError, StepFailed):
            pass
        except Exception as e:  # a malformed request: answer, keep serving
            log.debug("bad request", exc_info=True)
            try:
                writer.write(_json_response("400 Bad Request",
                                            {"error": str(e)}))
                await writer.drain()
            except _HANGUP:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except _HANGUP:
                pass

    async def _route(self, method: str, path: str, body: dict, reader,
                     writer) -> None:
        aeng = self.engine
        if (method, path) == ("POST", "/v1/generate"):
            await self._generate(reader, writer, body)
        elif (method, path) == ("POST", "/v1/cancel"):
            found = aeng.cancel(int(body["request_id"]))
            writer.write(_json_response("200 OK", {"cancelled": found}))
        elif (method, path) == ("GET", "/v1/health"):
            stats = dict(aeng.engine.overload.stats())
            stats["draining"] = aeng.draining
            stats["queue_depth"] = len(aeng.engine.scheduler.queue)
            writer.write(_json_response("200 OK", stats))
        elif (method, path) == ("POST", "/v1/drain"):
            await aeng.drain()
            writer.write(_json_response("200 OK", {"drained": True}))
        else:
            writer.write(_json_response(
                "404 Not Found", {"error": f"no route {method} {path}"}))

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader) -> tuple:
        request_line = (await reader.readline()).decode()
        if not request_line.strip():
            raise ValueError("empty request")
        method, path, _ = request_line.split(" ", 2)
        length = 0
        while True:
            line = (await reader.readline()).decode()
            if line in ("\r\n", "\n", ""):
                break
            name, _, value = line.partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        body = json.loads(await reader.readexactly(length)) if length else {}
        return method, path.strip(), body

    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, body: dict) -> None:
        aeng = self.engine
        try:
            rid = aeng.submit(body["prompt"],
                              int(body.get("max_new_tokens", 16)),
                              sampling_params=_parse_sampling(body))
        except DrainingError as e:
            writer.write(_json_response("503 Service Unavailable",
                                        {"error": str(e)}))
            return
        except ShedError as e:
            writer.write(_json_response(
                "429 Too Many Requests", {"error": str(e)},
                extra_headers=f"Retry-After: {e.retry_after_s:.3f}\r\n"))
            return
        except (ValueError, KeyError) as e:
            writer.write(_json_response("400 Bad Request",
                                        {"error": str(e)}))
            return
        writer.write(_SSE_HEADERS + _sse_event({"request_id": rid}))
        await writer.drain()
        # the body is read whole, so any EOF from here on is a hang-up; it
        # cancels the request, which ends its token batches
        eof = asyncio.ensure_future(reader.read(1))

        def hung_up(fut) -> None:
            if fut.cancelled():
                return
            fut.exception()  # a reset connection is a hang-up too
            if aeng.cancel(rid):
                log.info("client hung up, cancelled request %d", rid)

        eof.add_done_callback(hung_up)
        tokens, finished = [], False
        try:
            # a failed step (StepFailed) closes the stream without "done"
            async for batch in aeng.token_batches(rid):
                events = []
                for token, finished in batch:
                    events.append(_sse_event({"token": int(token),
                                              "index": len(tokens)}))
                    tokens.append(int(token))
                try:
                    writer.write(b"".join(events))
                    await writer.drain()
                except _HANGUP:
                    aeng.cancel(rid)
                    return
            if eof.done():  # hung up: nobody to tell
                return
            # a stream that ends unfinished was cancelled (/v1/cancel)
            final = ({"done": True, "request_id": rid, "tokens": tokens}
                     if finished else
                     {"done": True, "request_id": rid, "cancelled": True})
            writer.write(_sse_event(final))
            await writer.drain()
        finally:
            eof.cancel()


async def sse_generate(host: str, port: int, payload: dict):
    """A stdlib SSE client of ``POST /v1/generate``: yields each parsed
    event up to the ``done`` one. A response other than 200 (a shed's
    429, a drain's 503) raises ``RuntimeError`` with its status line and
    body."""
    body = json.dumps(payload).encode()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                      "Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        status = (await reader.readline()).decode()
        if "200" not in status:
            rest = await reader.read()
            raise RuntimeError(f"{status.strip()} {rest.decode()!r}")
        while (await reader.readline()) not in (b"\r\n", b"\n", b""):
            pass  # the response headers
        while True:
            line = await reader.readline()
            if not line:
                return
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            event = json.loads(line[len(b"data: "):])
            yield event
            if event.get("done"):
                return
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except _HANGUP:
            pass
