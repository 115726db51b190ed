"""llamafiler-analog HTTP server of the port: asyncio front end + the
continuous batcher's device thread.

Counterpart of llamafile_tpu/server/http.py (`Server`, `serve`, `_amain`)
for llama/mistral GGUFs. Sockets and SSE run on asyncio, so idle
connections are cheap; every generation goes through the continuous batcher
(server/batcher.py), which owns the device.

Endpoints: /v1/chat/completions /v1/completions /completion /tokenize
/detokenize /v1/models /slotz /flagz /health /metrics, with the reference's
behaviour: SSE streaming with x_prefill_progress events, stop strings held
back until they can no longer begin, `X-Priority: batch`, the token
bucket's 429, body and header limits, and message forgetting past the
context. /v1/completions also takes `prompt` as a list of token ids (the
OpenAI API's token-array form).

Left out of this port, each answering 501 with a message that names it:
/v1/embeddings and /embedding, `grammar` and `response_format`, image
content parts, /db/*, /slots/{id}?action=, mirostat, and the static web UI.
A model of another architecture makes Server raise at start.
"""
from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

from ..utils.flags import Flags
from ..version import VERSION_STRING
from .tokenbucket import TokenBucket

JSON_CT = "application/json"
_WEB_UI = (".html", ".js", ".css", ".png", ".svg", ".ico")


class Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.tokens_generated = 0
        self.tokens_prefilled = 0
        self.prefix_reused = 0
        self.queue_depth = 0
        self.started = time.time()

    def render(self) -> str:
        with self.lock:
            up = time.time() - self.started
            lines = [
                "# TYPE llamafile_tpu_requests_total counter",
                f"llamafile_tpu_requests_total {self.requests}",
                "# TYPE llamafile_tpu_tokens_generated_total counter",
                f"llamafile_tpu_tokens_generated_total {self.tokens_generated}",
                "# TYPE llamafile_tpu_tokens_prefilled_total counter",
                f"llamafile_tpu_tokens_prefilled_total {self.tokens_prefilled}",
                "# TYPE llamafile_tpu_prefix_tokens_reused_total counter",
                f"llamafile_tpu_prefix_tokens_reused_total {self.prefix_reused}",
                "# TYPE llamafile_tpu_queue_depth gauge",
                f"llamafile_tpu_queue_depth {self.queue_depth}",
                "# TYPE llamafile_tpu_uptime_seconds gauge",
                f"llamafile_tpu_uptime_seconds {up:.0f}",
            ]
        return "\n".join(lines) + "\n"


class Server:
    def __init__(self, flags: Flags, engine=None):
        self.flags = flags
        if engine is None:
            from ..runtime.engine import load_engine
            # load_llama raises NotImplementedError for other architectures
            engine = load_engine(flags.model, device=flags.device,
                                 max_seq_len=flags.ctx_size,
                                 kv_dtype=flags.kv_dtype)
        self.engine = engine
        from .batcher import Batcher
        self.batcher = Batcher(engine, rows=max(1, flags.slots),
                               preempt_after=flags.preempt)
        self.bucket = TokenBucket(flags.token_burst, flags.token_rate,
                                  flags.token_cidr, flags.trust)
        self.metrics = Metrics()
        nwork = flags.workers or (os.cpu_count() or 4) + 4
        self.pool = ThreadPoolExecutor(max_workers=max(2, min(nwork, 64)))
        self.model_id = os.path.basename(flags.model or "model")

    # ------------------------------------------------------------------
    # generation core (runs in pool threads)
    # ------------------------------------------------------------------

    def _generate_sync(self, prompt_ids, sp, max_tokens, stop_strs, emit,
                       low_priority=False):
        """Submit to the continuous batcher and stream its output queue.

        Stop strings are matched with holdback: the last len(stop)-1 chars
        stay unemitted until they can no longer begin a stop string, and a
        match truncates the text BEFORE the stop string (the reference
        server's behaviour: the stop text never reaches the client)."""
        tok = self.engine.tokenizer
        t_start = time.time()
        req = self.batcher.submit(prompt_ids, sp, max_tokens,
                                  low_priority=low_priority)
        hold = max((len(s) for s in stop_strs), default=1) - 1
        text_acc = ""
        emitted = 0                  # chars of text_acc already emitted
        n_out = 0
        finish = "length"
        ttft = None
        try:
            while True:
                kind, val = req.out.get(timeout=600)
                if kind == "error":
                    raise RuntimeError(val)
                if kind == "done":
                    finish = val
                    break
                if kind == "progress":
                    emit({"prefill_progress": val[0] / max(1, val[1])})
                    continue
                if ttft is None:
                    ttft = time.time() - t_start
                piece = tok.decode_token(val).decode("utf-8", errors="replace")
                text_acc += piece
                n_out += 1
                if stop_strs:
                    cut = min((text_acc.find(s) for s in stop_strs
                               if s in text_acc), default=-1)
                    if cut >= 0:
                        req.stop = True
                        finish = "stop"
                        text_acc = text_acc[:cut]
                        if cut > emitted:
                            emit({"piece": text_acc[emitted:]})
                            emitted = cut
                        break
                safe = len(text_acc) - hold
                if safe > emitted:
                    emit({"token": val, "piece": text_acc[emitted:safe]})
                    emitted = safe
            if emitted < len(text_acc):      # flush holdback on done
                emit({"piece": text_acc[emitted:]})
        finally:
            req.stop = True
        with self.metrics.lock:
            self.metrics.tokens_generated += n_out
            self.metrics.tokens_prefilled += len(prompt_ids)
        return {"prompt_tokens": len(prompt_ids),
                "completion_tokens": n_out,
                "finish_reason": finish,
                "ttft_ms": round((ttft or 0.0) * 1e3, 2),
                "text": text_acc}

    async def generate(self, prompt_ids, sp, max_tokens, stop_strs,
                       on_piece=None, low_priority=False):
        """Async wrapper: runs _generate_sync in the pool, streaming pieces."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def emit(piece):
            loop.call_soon_threadsafe(queue.put_nowait, piece)

        fut = loop.run_in_executor(self.pool, self._generate_sync, prompt_ids,
                                   sp, max_tokens, stop_strs, emit,
                                   low_priority)
        while True:
            get = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait({get, fut},
                                         return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                piece = get.result()
                if on_piece:
                    await on_piece(piece)
                continue
            get.cancel()
            while not queue.empty():
                piece = queue.get_nowait()
                if on_piece:
                    await on_piece(piece)
            return fut.result()

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------

    MAX_BODY = 32 * 1024 * 1024
    MAX_HEADER_LINES = 100
    IDLE_TIMEOUT = 300.0          # keep-alive idle
    READ_TIMEOUT = 60.0           # per header-line / body read

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername") or ("?", 0)
        ip = peer[0]
        try:
            while True:
                try:
                    line = await asyncio.wait_for(reader.readline(),
                                                  self.IDLE_TIMEOUT)
                except asyncio.TimeoutError:
                    return
                if not line:
                    return
                try:
                    method, target, _ver = line.decode().split()
                except ValueError:
                    return await self._plain(writer, 400, "bad request line")
                # charge the rate limit BEFORE buffering the body
                if not self.bucket.acquire(ip):
                    return await self._plain(writer, 429, "too many requests")
                headers = {}
                for _ in range(self.MAX_HEADER_LINES):
                    try:
                        h = await asyncio.wait_for(reader.readline(),
                                                   self.READ_TIMEOUT)
                    except asyncio.TimeoutError:
                        return
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                else:
                    return await self._plain(writer, 431, "too many headers")
                body = b""
                n = int(headers.get("content-length", 0) or 0)
                if n > self.MAX_BODY:
                    return await self._plain(writer, 413, "body too large")
                if n:
                    try:
                        body = await asyncio.wait_for(reader.readexactly(n),
                                                      self.READ_TIMEOUT)
                    except asyncio.TimeoutError:
                        return
                with self.metrics.lock:
                    self.metrics.requests += 1
                t_req = time.time()
                keep = await self.dispatch(writer, method, target, headers, body)
                from ..utils.log import access_log
                access_log.info("%s %s %s %.0fms", ip, method,
                                target.split("?")[0], (time.time() - t_req) * 1e3)
                await writer.drain()
                if not keep or headers.get("connection", "").lower() == "close":
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def dispatch(self, w, method, target, headers, body) -> bool:
        path = target.split("?", 1)[0]
        prefix = self.flags.url_prefix.rstrip("/")
        if prefix and path.startswith(prefix):
            path = path[len(prefix):] or "/"
        try:
            payload = json.loads(body) if body else {}
        except json.JSONDecodeError:
            await self._json(w, 400, {"error": "invalid JSON body"})
            return True
        unported = self._unported_route(path)
        if unported:
            return await self._json(w, 501, {"error": f"{unported} is not "
                                             "ported to llamafile_tpu_torch yet"})
        route = {
            "/v1/chat/completions": self.ep_chat,
            "/v1/completions": self.ep_completions,
            "/completion": self.ep_completion_legacy,
            "/tokenize": self.ep_tokenize,
            "/detokenize": self.ep_detokenize,
            "/v1/models": self.ep_models,
            "/slotz": self.ep_slotz,
            "/flagz": self.ep_flagz,
            "/health": self.ep_health,
            "/metrics": self.ep_metrics,
        }.get(path)
        if route is None:
            return await self._plain(w, 404, "not found")
        try:
            return await route(w, method, target, headers, payload)
        except NotImplementedError as e:       # what the port leaves out
            return await self._json(w, 501, {"error": str(e)})

    @staticmethod
    def _unported_route(path: str):
        if path in ("/v1/embeddings", "/embedding"):
            return f"{path} (embeddings)"
        if path.startswith("/db/"):
            return "/db (chat persistence)"
        if path.startswith("/slots/"):
            return "/slots/{id}?action= (slot save/restore)"
        if path == "/" or os.path.splitext(path)[1] in _WEB_UI:
            return "the static web UI"
        return None

    async def _plain(self, w, status, text, ct="text/plain"):
        data = text.encode() if isinstance(text, str) else text
        w.write((f"HTTP/1.1 {status} {_reason(status)}\r\n"
                 f"Content-Type: {ct}\r\nContent-Length: {len(data)}\r\n"
                 f"Server: llamafile-tpu/{VERSION_STRING}\r\n\r\n").encode())
        w.write(data)
        return True

    async def _json(self, w, status, obj):
        return await self._plain(w, status, json.dumps(obj), JSON_CT)

    # ------------------------------------------------------------------
    # endpoints
    # ------------------------------------------------------------------

    async def ep_health(self, w, *a):
        # liveness = the DEVICE answers (a tiny op read back), and the
        # batcher's device thread is alive; cached for 5 s
        now = time.time()
        if now - getattr(self, "_health_t", 0.0) > 5.0:
            loop = asyncio.get_running_loop()
            dev = self.engine.device

            def probe():
                import torch
                return int((torch.ones((), device=dev) + 1).item())

            try:
                ok = await asyncio.wait_for(
                    loop.run_in_executor(self.pool, probe), timeout=30.0)
                self._health_ok = ok == 2
            except Exception:
                self._health_ok = False
            self._health_t = now
        if getattr(self, "_health_ok", True) and self.batcher.alive():
            return await self._json(w, 200, {"status": "ok"})
        return await self._json(w, 503, {"status": "device unresponsive"})

    async def ep_metrics(self, w, *a):
        st = self.batcher.stats
        with self.metrics.lock:
            self.metrics.prefix_reused = st.get("reused_tokens", 0)
            self.metrics.queue_depth = (self.batcher.queue.qsize()
                                        + self.batcher.batch_queue.qsize())
        return await self._plain(w, 200, self.metrics.render(),
                                 "text/plain; version=0.0.4")

    async def ep_models(self, w, *a):
        return await self._json(w, 200, {"object": "list", "data": [{
            "id": self.model_id, "object": "model", "owned_by": "llamafile-tpu",
        }]})

    async def ep_slotz(self, w, *a):
        return await self._json(w, 200, {"slots": self.batcher.describe(),
                                         "queued": self.batcher.queue.qsize(),
                                         "cache": self.batcher.describe_stats()})

    async def ep_flagz(self, w, *a):
        from dataclasses import asdict
        return await self._json(w, 200, asdict(self.flags))

    async def ep_tokenize(self, w, method, target, headers, payload):
        text = payload.get("content", payload.get("prompt", ""))
        add_special = payload.get("add_special", True)
        ids = self.engine.tokenizer.encode(text, add_bos=add_special and None)
        return await self._json(w, 200, {"tokens": ids})

    async def ep_detokenize(self, w, method, target, headers, payload):
        ids = payload.get("tokens", [])
        return await self._json(w, 200,
                                {"content": self.engine.tokenizer.decode(ids)})

    def _chat_prompt_ids(self, payload) -> list:
        from ..runtime.chat import apply_chat_template
        messages = payload.get("messages", [])
        tok = self.engine.tokenizer
        render = lambda ms: tok.encode(apply_chat_template(
            [{"role": m.get("role", "user"), "content": _content_str(m)}
             for m in ms], self.flags.chat_template or tok.chat_template))
        ids = render(messages)
        # auto message forgetting past the context (v1_chat_completions.cpp:565-597)
        limit = self.engine.max_seq_len - self._reserve()
        while len(ids) > limit and len(messages) > 2:
            messages = ([messages[0]] + messages[3:]
                        if messages[0].get("role") == "system" else messages[2:])
            ids = render(messages)
        return ids[-limit:] if len(ids) > limit else ids

    def _reserve(self) -> int:
        r = self.flags.reserve_tokens
        return r if r >= 0 else max(16, self.engine.max_seq_len * 15 // 100)

    def _sp(self, payload):
        from ..runtime.sampling import SamplingParams
        for key in ("grammar", "response_format"):
            if payload.get(key):
                raise NotImplementedError(f"`{key}` (grammar-constrained decoding) is not "
                               "ported to llamafile_tpu_torch yet")
        if int(payload.get("mirostat", self.flags.mirostat) or 0):
            raise NotImplementedError("mirostat is not ported to llamafile_tpu_torch yet")
        # OpenAI-style logit_bias map ({"token_id": bias}) -> hashable tuple
        lb = payload.get("logit_bias") or {}
        try:
            bias = tuple(sorted((int(t), float(x)) for t, x in lb.items()))
        except (TypeError, ValueError, AttributeError):
            bias = ()
        return SamplingParams(
            temperature=float(payload.get("temperature", self.flags.temp)),
            top_p=float(payload.get("top_p", self.flags.top_p)),
            top_k=int(payload.get("top_k", self.flags.top_k)),
            min_p=float(payload.get("min_p", self.flags.min_p)),
            tfs_z=float(payload.get("tfs_z", 1.0)),
            typical_p=float(payload.get("typical_p", 1.0)),
            dynatemp_range=float(payload.get("dynatemp_range", 0.0)),
            dynatemp_exponent=float(payload.get("dynatemp_exponent", 1.0)),
            repeat_penalty=float(payload.get("repeat_penalty", 1.0)),
            presence_penalty=float(payload.get("presence_penalty", 0.0)),
            frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
            penalty_last_n=int(payload.get("repeat_last_n",
                                           payload.get("penalty_last_n", 64))),
            logit_bias=bias,
            seed=int(payload.get("seed", self.flags.seed)),
        )

    async def ep_chat(self, w, method, target, headers, payload):
        if method != "POST":
            return await self._json(w, 405, {"error": "POST required"})
        if any(isinstance(m.get("content"), list)
               and any(p.get("type") == "image_url" for p in m["content"])
               for m in payload.get("messages", [])):
            raise NotImplementedError("image content parts (multimodal) are not ported "
                           "to llamafile_tpu_torch yet")
        ids = self._chat_prompt_ids(payload)
        return await self._run_completion(
            w, payload, ids, chat=True,
            low_priority=headers.get("x-priority", "") == "batch")

    async def ep_completion_legacy(self, w, method, target, headers, payload):
        """llama.cpp-server-style /completion (n_predict, content result)."""
        payload = dict(payload)
        if "n_predict" in payload and "max_tokens" not in payload:
            payload["max_tokens"] = payload["n_predict"]
        sp = self._sp(payload)
        ids = self.engine.tokenizer.encode(str(payload.get("prompt", "")))
        limit = self.engine.max_seq_len - self._reserve()
        try:
            usage = await self.generate(ids[-limit:], sp,
                                        int(payload.get("max_tokens", 128) or 128),
                                        payload.get("stop") or [])
        except RuntimeError as e:
            return await self._json(w, 500, {"error": str(e)})
        return await self._json(w, 200, {
            "content": usage["text"],
            "stop": usage["finish_reason"] == "stop",
            "tokens_predicted": usage["completion_tokens"],
            "tokens_evaluated": usage["prompt_tokens"],
            "timings": {"ttft_ms": usage["ttft_ms"]},
        })

    async def ep_completions(self, w, method, target, headers, payload):
        if method != "POST":
            return await self._json(w, 405, {"error": "POST required"})
        prompt = payload.get("prompt", "")
        if isinstance(prompt, list) and prompt and all(
                isinstance(t, int) for t in prompt):
            ids = list(prompt)                 # the token-array form
        else:
            if isinstance(prompt, list):
                prompt = "".join(prompt)
            ids = self.engine.tokenizer.encode(prompt)
        limit = self.engine.max_seq_len - self._reserve()
        ids = ids[-limit:]
        return await self._run_completion(
            w, payload, ids, chat=False,
            low_priority=headers.get("x-priority", "") == "batch")

    async def _run_completion(self, w, payload, ids, chat: bool,
                              low_priority: bool = False):
        sp = self._sp(payload)
        max_tokens = int(payload.get("max_tokens",
                                     payload.get("n_predict", 0)) or 0)
        if max_tokens <= 0:
            max_tokens = self.engine.max_seq_len - len(ids) - 1
        stop = payload.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        obj = "chat.completion" if chat else "text_completion"
        if payload.get("stream"):
            w.write((f"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     "Cache-Control: no-store\r\nConnection: close\r\n"
                     "Transfer-Encoding: chunked\r\n\r\n").encode())

            async def send_evt(data):
                blob = f"data: {json.dumps(data)}\n\n".encode()
                w.write(f"{len(blob):x}\r\n".encode() + blob + b"\r\n")
                await w.drain()

            evt = lambda choice, **kw: {
                "id": rid, "object": obj + (".chunk" if chat else ""),
                "created": created, "model": self.model_id,
                "choices": [choice], **kw}
            if chat:
                await send_evt(evt({"index": 0, "delta": {"role": "assistant"},
                                    "finish_reason": None}))

            async def on_piece(p):
                if "prefill_progress" in p:
                    # x_prefill_progress events (v1_chat_completions.cpp:630-644)
                    await send_evt(evt(
                        {"index": 0, "delta": {"content": ""},
                         "finish_reason": None} if chat else
                        {"index": 0, "text": "", "finish_reason": None},
                        x_prefill_progress=round(p["prefill_progress"], 4)))
                    return
                await send_evt(evt(
                    {"index": 0, "delta": {"content": p["piece"]},
                     "finish_reason": None} if chat else
                    {"index": 0, "text": p["piece"], "finish_reason": None}))

            try:
                usage = await self.generate(ids, sp, max_tokens, stop, on_piece,
                                            low_priority=low_priority)
                await send_evt(evt(
                    {"index": 0, "delta": {}, "finish_reason": usage["finish_reason"]}
                    if chat else
                    {"index": 0, "text": "", "finish_reason": usage["finish_reason"]},
                    usage=_usage(usage)))
            except RuntimeError as e:
                await send_evt({"error": str(e)})
            blob = b"data: [DONE]\n\n"
            w.write(f"{len(blob):x}\r\n".encode() + blob + b"\r\n0\r\n\r\n")
            return False
        try:
            usage = await self.generate(ids, sp, max_tokens, stop,
                                        low_priority=low_priority)
        except RuntimeError as e:
            return await self._json(w, 500, {"error": str(e)})
        text = usage.pop("text")
        choice = ({"index": 0, "message": {"role": "assistant", "content": text},
                   "finish_reason": usage["finish_reason"]} if chat else
                  {"index": 0, "text": text,
                   "finish_reason": usage["finish_reason"]})
        return await self._json(w, 200, {
            "id": rid, "object": obj, "created": created,
            "model": self.model_id, "choices": [choice], "usage": _usage(usage),
        })


def _usage(u):
    return {"prompt_tokens": u["prompt_tokens"],
            "completion_tokens": u["completion_tokens"],
            "total_tokens": u["prompt_tokens"] + u["completion_tokens"],
            "ttft_ms": u.get("ttft_ms")}


def _content_str(m) -> str:
    c = m.get("content", "")
    if isinstance(c, list):  # OpenAI content-parts form
        return "".join(p.get("text", "") for p in c if p.get("type") == "text")
    return str(c)


def _reason(status: int) -> str:
    return {200: "OK", 400: "Bad Request", 403: "Forbidden", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 431: "Request Header Fields Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}.get(status, "OK")


async def _amain(server: Server, host: str, port: int, ready=None):
    srv = await asyncio.start_server(server.handle, host, port)
    if ready is not None:
        ready.set_result((host, port))
    print(f"llamafile-tpu-torch server listening on http://{host}:{port}/",
          flush=True)
    async with srv:
        await srv.serve_forever()


def serve(flags: Flags, engine=None) -> int:
    host, _, port = flags.listen.rpartition(":")
    server = Server(flags, engine)
    try:
        asyncio.run(_amain(server, host or "127.0.0.1", int(port)))
    except KeyboardInterrupt:
        print("shutdown")
    finally:
        server.batcher.shutdown()
        server.pool.shutdown(wait=False)
    return 0
