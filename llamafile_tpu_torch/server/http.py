"""llamafiler-analog HTTP server of the port: asyncio front end + the
continuous batcher's device thread.

Counterpart of llamafile_tpu/server/http.py (`Server`, `serve`, `_amain`)
for llama/mistral GGUFs. Sockets and SSE run on asyncio, so idle
connections are cheap; every generation goes through the continuous batcher
(server/batcher.py), which owns the device.

Endpoints: /v1/chat/completions /v1/completions /completion /tokenize
/detokenize /v1/embeddings /embedding /v1/models /slotz /flagz /health
/metrics /slots/{id}?action=save|restore|erase, /db/* (the web UI's chat
persistence under --db, server/db.py) and every other path as a static
file of the web UI (the port's copy in server/www, or --www-root), with
the reference's
behaviour: SSE streaming with x_prefill_progress events, stop strings held
back until they can no longer begin, `X-Priority: batch`, the token
bucket's 429, body and header limits, and message forgetting past the
context. /v1/completions also takes `prompt` as a list of token ids (the
OpenAI API's token-array form). /v1/embeddings and /embedding take `input`
or `content`, a string or a list of strings (or, as OpenAI's API, of token
arrays: a port extension); their requests collect into
padded batched forwards on the EmbedBatcher's thread (server/embed.py).

A `grammar` (raw GBNF) or a `response_format` (`json_schema`, with or
without an inner `schema`, or `json_object`) makes a request constrained:
it runs on a private dense row in a pool thread (`_generate_grammar_sync`:
Engine.prefill, then one M = 1 forward a token, the allowed-token mask
sent to the device as packed bits), beside the batcher's rows; stop
strings do not apply there, as in the reference. /slots/{id}?action=
saves, restores or erases a batcher row's KV under --state-dir
(runtime/state.py files).

Left out of this port, each answering 501 with a message that names it:
image content parts and mirostat (the reference's server reads its knobs
and samples without them: ROADMAP C.10). A model of another architecture
makes Server raise at start.
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
        # cross-request embedding micro-batching: one padded forward a tick
        from .embed import EmbedBatcher, llama_embed_many
        self.embedder = EmbedBatcher(
            llama_embed_many(engine),
            tokenize=lambda t: (t if isinstance(t, list) else engine.tokenizer.encode(t))[
                : engine.max_seq_len - 1])
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

    def _generate_grammar_sync(self, prompt_ids, sp, max_tokens, emit, grammar):
        """Constrained decoding on a private dense row: the pushdown stacks
        advance on the host (the next mask depends on the accepted token);
        the allowed-token mask goes to the device as packed bits (V/8
        bytes), is unpacked there and fills the disallowed logits with
        -1e30 before `sample` (logit bias yes, no penalty window, as the
        reference's grammar step). Stops on EOG, on a complete grammar with
        no live stack, at the context's end or at max_tokens.

        It runs on the device's default stream, as the batcher's thread
        does, so the two paths' kernels never overlap (the product kernels
        share their split-K counters on a stream), and it shares no tensor
        with the batcher."""
        import torch
        from ..models.llama import forward
        from ..runtime.engine import attn_bucket
        from ..runtime.grammar import GrammarSampler
        from ..runtime.sampling import sample
        eng = self.engine
        tok = eng.tokenizer
        dev = eng.device
        gs = GrammarSampler(grammar, tok)
        nv = eng.cfg.n_vocab
        t_start = time.time()
        cache = eng.new_cache()
        last, cache = eng.prefill(cache, prompt_ids)
        ttft = time.time() - t_start
        gen = torch.Generator(device=dev)
        gen.manual_seed((sp.seed or int(time.time() * 1e6) % 2**31)
                        & 0x7FFFFFFFFFFFFFFF)
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)

        def pick(logits):
            bits = grammar_bits(gs.allowed_tokens(), nv)
            m = (torch.from_numpy(bits).to(dev)[:, None] >> shifts) & 1
            masked = torch.where(m.reshape(-1)[:nv].bool(), logits[:nv],
                                 torch.full((nv,), -1e30, device=dev))
            return int(sample(masked[None, :], gen, sp)[0])

        pos = len(prompt_ids)
        text_acc = ""
        n_out = 0
        finish = "length"
        tid = pick(last)
        for _ in range(max_tokens):
            if tok.is_eog(tid):
                finish = "stop"
                break
            gs.accept(tid)
            piece = tok.decode_token(tid).decode("utf-8", errors="replace")
            text_acc += piece
            n_out += 1
            emit({"token": tid, "piece": piece})
            if gs.done and not any(len(s) for s in gs.stacks):
                finish = "stop"
                break
            if pos + 1 >= eng.max_seq_len or n_out >= max_tokens:
                break
            logits, cache = forward(
                eng.params, eng.cfg, torch.tensor([[tid]], dtype=torch.int32, device=dev),
                torch.tensor([pos], dtype=torch.int32, device=dev), cache,
                attn_len=attn_bucket(pos + 1, eng.max_seq_len))
            tid = pick(logits[0, -1])
            pos += 1
        with self.metrics.lock:
            self.metrics.tokens_generated += n_out
            self.metrics.tokens_prefilled += len(prompt_ids)
        return {"prompt_tokens": len(prompt_ids), "completion_tokens": n_out,
                "finish_reason": finish, "ttft_ms": round(ttft * 1e3, 2),
                "text": text_acc}

    async def generate(self, prompt_ids, sp, max_tokens, stop_strs,
                       on_piece=None, low_priority=False, grammar=None):
        """Async wrapper: runs the request's generator in the pool,
        streaming pieces: the continuous batcher's, or with a grammar the
        private constrained row's."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def emit(piece):
            loop.call_soon_threadsafe(queue.put_nowait, piece)

        if grammar is not None:
            fut = loop.run_in_executor(self.pool, self._generate_grammar_sync,
                                       prompt_ids, sp, max_tokens, emit, grammar)
        else:
            fut = loop.run_in_executor(self.pool, self._generate_sync,
                                       prompt_ids, sp, max_tokens, stop_strs,
                                       emit, low_priority)
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
        if path.startswith("/db/"):
            return await self.ep_db(w, method, path, payload)
        if path.startswith("/slots/"):
            return await self.ep_slot_action(w, method, path, target, payload)
        route = {
            "/v1/chat/completions": self.ep_chat,
            "/v1/completions": self.ep_completions,
            "/completion": self.ep_completion_legacy,
            "/tokenize": self.ep_tokenize,
            "/detokenize": self.ep_detokenize,
            "/v1/embeddings": self.ep_embedding,
            "/embedding": self.ep_embedding,
            "/v1/models": self.ep_models,
            "/slotz": self.ep_slotz,
            "/flagz": self.ep_flagz,
            "/health": self.ep_health,
            "/metrics": self.ep_metrics,
        }.get(path)
        if route is None:
            return await self.ep_static(w, path)
        try:
            return await route(w, method, target, headers, payload)
        except NotImplementedError as e:       # what the port leaves out
            return await self._json(w, 501, {"error": str(e)})

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

    async def ep_slot_action(self, w, method, path, target, payload):
        """POST /slots/{id}?action=save|restore|erase: a batcher row's KV
        state to or from a file under --state-dir (the name reduced to its
        basename). 400 without --state-dir, for a bad slot id or action and
        a missing filename; 404 for a missing file; 409 for a busy row."""
        if method != "POST":
            return await self._json(w, 405, {"error": "POST required"})
        state_dir = self.flags.state_dir
        if not state_dir:
            return await self._json(
                w, 400, {"error": "server started without --state-dir"})
        try:
            ridx = int(path.split("/")[2])
        except (IndexError, ValueError):
            return await self._json(w, 400, {"error": "bad slot id"})
        from urllib.parse import parse_qs, urlparse
        action = parse_qs(urlparse(target).query).get("action", [""])[0]
        if action not in ("save", "restore", "erase"):
            return await self._json(
                w, 400, {"error": "action must be save|restore|erase"})
        fname = os.path.basename(str(payload.get("filename", "")))
        if action in ("save", "restore") and not fname:
            return await self._json(w, 400, {"error": "filename required"})
        if action != "restore" and not 0 <= ridx < self.batcher.n_rows:
            return await self._json(w, 400, {"error": "bad slot id"})
        fpath = os.path.join(state_dir, fname)
        if action == "restore" and not os.path.exists(fpath):
            return await self._json(w, 404, {"error": "no such file"})
        if action == "save":
            os.makedirs(state_dir, exist_ok=True)
        run = {"save": lambda: self.batcher.save_row(ridx, fpath),
               "restore": lambda: self.batcher.restore_row(fpath),
               "erase": lambda: self.batcher.erase_row(ridx)}[action]
        try:
            r = await asyncio.get_running_loop().run_in_executor(self.pool, run)
        except RuntimeError as e:
            return await self._json(w, 409, {"error": str(e)})
        return await self._json(w, 200, r)

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

    async def ep_embedding(self, w, method, target, headers, payload):
        inp = payload.get("input", payload.get("content", ""))
        if isinstance(inp, list) and inp and all(isinstance(t, int) for t in inp):
            inp = [inp]                        # one token array (OpenAI's form)
        inputs = inp if isinstance(inp, list) else [inp]
        loop = asyncio.get_running_loop()
        # concurrent requests micro-batch into one padded forward
        vecs = await loop.run_in_executor(self.pool, self.embedder.embed, inputs)
        tok = self.engine.tokenizer
        ntok = sum(len(t) if isinstance(t, list) else len(tok.encode(t)) for t in inputs)
        data = [{"object": "embedding", "index": i, "embedding": v}
                for i, v in enumerate(vecs)]
        return await self._json(w, 200, {
            "object": "list", "data": data, "model": self.model_id,
            "usage": {"prompt_tokens": ntok},
        })

    def shutdown(self):
        """Stop the batcher's and the embedder's threads and the pool."""
        self.batcher.shutdown()
        self.embedder.shutdown()
        self.pool.shutdown(wait=False)

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
        if int(payload.get("mirostat", self.flags.mirostat) or 0):
            # the reference's server reads the knobs and drops them (C.10)
            raise NotImplementedError("mirostat under --server is not ported to "
                                      "llamafile_tpu_torch yet")
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
        try:
            grammar = self._grammar_for(payload)
        except Exception as e:          # noqa: BLE001 — any parse error is a 400
            return await self._json(w, 400, {"error": f"bad grammar/schema: {e}"})
        ids = self.engine.tokenizer.encode(str(payload.get("prompt", "")))
        limit = self.engine.max_seq_len - self._reserve()
        try:
            usage = await self.generate(ids[-limit:], sp,
                                        int(payload.get("max_tokens", 128) or 128),
                                        payload.get("stop") or [], grammar=grammar)
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

    def _grammar_for(self, payload):
        """A raw GBNF `grammar`, or `response_format` json_schema (with or
        without an inner `schema`) or json_object, as a Grammar; None for an
        unconstrained request."""
        from ..runtime.grammar import Grammar
        rf = payload.get("response_format") or {}
        if payload.get("grammar"):
            return Grammar.from_gbnf(payload["grammar"])
        if rf.get("type") == "json_schema":
            schema = rf.get("json_schema", {})
            return Grammar.from_json_schema(schema.get("schema", schema))
        if rf.get("type") == "json_object":
            return Grammar.from_json_schema({})
        return None

    async def _run_completion(self, w, payload, ids, chat: bool,
                              low_priority: bool = False):
        sp = self._sp(payload)
        try:
            grammar = self._grammar_for(payload)
        except Exception as e:          # noqa: BLE001 — any parse error is a 400
            return await self._json(w, 400, {"error": f"bad grammar/schema: {e}"})
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
                                            low_priority=low_priority,
                                            grammar=grammar)
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
                                        low_priority=low_priority,
                                        grammar=grammar)
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


    def _db(self):
        if getattr(self, "_db_inst", None) is None:
            if not self.flags.db:
                return None
            from .db import Db
            self._db_inst = Db(self.flags.db)
        return self._db_inst

    async def ep_db(self, w, method, path, payload):
        """The web UI's chat persistence (llamafile's db.cpp routes)."""
        db = self._db()
        if db is None:
            return await self._json(w, 404, {"error": "no --db configured"})
        parts = [p for p in path.split("/") if p][1:]     # after "db"
        if parts == ["chats"]:
            if method == "POST":
                cid = db.create_chat(self.model_id, payload.get("title", ""))
                return await self._json(w, 200, {"id": cid})
            return await self._json(w, 200, {"chats": db.list_chats()})
        if len(parts) == 2 and parts[0] == "chats":
            cid = int(parts[1])
            if method == "DELETE":
                db.delete_chat(cid)
                return await self._json(w, 200, {"ok": True})
            chat = db.get_chat(cid)
            if chat is None:
                return await self._json(w, 404, {"error": "no such chat"})
            chat["messages"] = db.list_messages(cid)
            return await self._json(w, 200, chat)
        if len(parts) == 3 and parts[0] == "chats" and parts[2] == "messages":
            cid = int(parts[1])
            if method == "POST":
                mid = db.add_message(cid, payload.get("role", "user"),
                                     payload.get("content", ""),
                                     float(payload.get("temperature", 0.0)),
                                     float(payload.get("top_p", 1.0)))
                return await self._json(w, 200, {"id": mid})
            return await self._json(w, 200, {"messages": db.list_messages(cid)})
        return await self._json(w, 404, {"error": "unknown db route"})

    async def ep_static(self, w, path):
        """A file of the web UI: the port's packaged copy, or --www-root."""
        root = self.flags.www_root or os.path.join(os.path.dirname(__file__), "www")
        safe = os.path.normpath(path).lstrip("/") or "index.html"
        full = os.path.join(root, safe)
        if not os.path.abspath(full).startswith(os.path.abspath(root)):
            return await self._plain(w, 403, "forbidden")
        if os.path.isdir(full):
            full = os.path.join(full, "index.html")
        if not os.path.exists(full):
            return await self._plain(w, 404, "not found")
        ct = {"html": "text/html", "js": "text/javascript", "css": "text/css",
              "png": "image/png", "svg": "image/svg+xml",
              "json": JSON_CT}.get(full.rsplit(".", 1)[-1], "application/octet-stream")
        with open(full, "rb") as f:
            return await self._plain(w, 200, f.read(), ct)


def grammar_bits(mask, nv: int):
    """The allowed-token mask as packed bits [ceil(nv / 8)] uint8 (the
    first token in the high bit, np.packbits' order), cut or padded to
    nv tokens."""
    import numpy as np
    m = np.zeros((nv,), bool)
    m[: min(len(mask), nv)] = mask[:nv]
    return np.packbits(m)


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
        server.shutdown()
    return 0
