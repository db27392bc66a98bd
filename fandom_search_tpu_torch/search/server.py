"""Persistent serving mode; counterpart of fandom_search_tpu/search/server.py.

``python -m fandom_search_tpu_torch serve`` keeps ONE engine resident —
the script index on the card, the kernel library built and loaded by a
warmup search — behind a localhost HTTP/JSON API, so an interactive
client (e.g. a Fan Engagement Meter backend) pays only the search itself
per request, not process start, index upload and the nvcc build.

Endpoints (JSON over HTTP/1.1), the JAX package's schema:

  GET  /health  -> {"status": "ok", index/device facts}
  GET  /stats   -> cumulative counters since startup
  POST /search  -> {"works": {id: text, ...}}  or  {"text": "..."}
                   (single anonymous work, id "query");
                   optional "include_stats": true
                -> {"matches": [MatchRow dicts], "works": N, ...}

Concurrency: stdlib ThreadingHTTPServer (thread per connection), with
every engine call serialized behind a lock: the engine pipelines its own
device work on one stream, and two searches interleaving their batches
would share its sticky budgets and its device.  Binds 127.0.0.1 by
default; this is an app-backend socket, not an internet face.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

from fandom_search_tpu_torch.search.types import MatchRow

log = logging.getLogger(__name__)

_MAX_BODY = 512 << 20  # refuse absurd request bodies (512 MB)


class SearchService:
    """Resident engine + counters; the object the HTTP layer fronts."""

    def __init__(self, engine, index, cfg) -> None:
        self.engine = engine
        self.index = index
        self.cfg = cfg
        self._lock = threading.Lock()
        # counters are read-modify-written from every handler thread
        # after the engine lock is released, so they have their own lock
        self._stats_lock = threading.Lock()
        self._t0 = time.time()
        self.counters = {
            "requests": 0, "works": 0, "query_shingles": 0,
            "matches": 0, "search_seconds": 0.0, "queue_seconds": 0.0,
            "errors": 0,
        }

    def bump(self, **deltas) -> None:
        with self._stats_lock:
            for key, d in deltas.items():
                self.counters[key] += d

    def warm(self) -> float:
        """Search one tiny synthetic work before the first request (on
        the card this builds and loads the kernel library and launches
        every kernel of the path once); returns seconds spent.

        Deliberately nonsense words: script text here would flood the
        candidate stage and sticky-bump the engine's budgets for every
        later batch."""
        t0 = time.perf_counter()
        text = " ".join(f"warmup{i}" for i in range(64))
        with self._lock:
            self.engine.search_works({"__warm__": text})
        return time.perf_counter() - t0

    def search(self, works: Dict[str, str]) -> Tuple[list, dict]:
        # Queue wait is measured apart from engine time: requests
        # serialize behind one engine lock, so under concurrent clients
        # latency is queue + search, and the response meta shows both.
        t_q = time.perf_counter()
        with self._lock:
            queued = time.perf_counter() - t_q
            t0 = time.perf_counter()
            rows, stats = self.engine.search_works(works)
            dt = time.perf_counter() - t0
        self.bump(
            requests=1,
            works=len(works),
            query_shingles=stats.num_query_shingles,
            matches=len(rows),
            search_seconds=dt,
            queue_seconds=queued,
        )
        meta = {
            "works": len(works),
            "num_matches": len(rows),
            "query_shingles": stats.num_query_shingles,
            "seconds": round(dt, 4),
            "queue_seconds": round(queued, 4),
        }
        if stats.extra:
            # per-run engine observability (stage timings)
            meta["engine_extra"] = {
                k: round(float(v), 6) for k, v in stats.extra.items()
            }
        return rows, meta

    def health(self) -> dict:
        dev = self.engine.device
        if dev.type == "cuda":
            import torch

            device = f"cuda:{torch.cuda.get_device_name(dev)}"
        else:
            device = "cpu"
        return {
            "status": "ok",
            "script_lines": len(self.index.lines),
            "script_shingles": self.index.num_shingles,
            "device": device,
            "uptime_seconds": round(time.time() - self._t0, 1),
        }

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self.counters)
        out["uptime_seconds"] = round(time.time() - self._t0, 1)
        out["search_seconds"] = round(out["search_seconds"], 3)
        out["queue_seconds"] = round(out["queue_seconds"], 3)
        return out


def _rows_json(rows) -> list:
    return [dict(zip(MatchRow.CSV_FIELDS, r.to_csv_row())) for r in rows]


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        # keep request logging on our logger, not stderr
        def log_message(self, fmt, *args):  # noqa: N802
            log.debug("%s - %s", self.address_string(), fmt % args)

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._reply(200, service.health())
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/search":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= _MAX_BODY:
                    self._reply(413, {"error": "bad Content-Length"})
                    return
                req = json.loads(self.rfile.read(length))
                if not isinstance(req, dict):
                    self._reply(400, {"error": "body must be a JSON object"})
                    return
                works = req.get("works")
                if works is None and "text" in req:
                    works = {"query": req["text"]}
                if (
                    not isinstance(works, dict) or not works
                    or not all(
                        isinstance(k, str) and isinstance(v, str)
                        for k, v in works.items()
                    )
                ):
                    self._reply(400, {
                        "error": 'body must carry {"works": {id: text}} '
                                 'or {"text": "..."}'
                    })
                    return
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                rows, summary = service.search(works)
            except Exception as e:  # an engine failure must not end serving
                service.bump(errors=1)
                log.exception("search request failed")
                self._reply(500, {"error": f"search failed: {e}"})
                return
            out = {"matches": _rows_json(rows), **summary}
            if req.get("include_stats"):
                out["server_stats"] = service.stats()
            self._reply(200, out)

    return Handler


def make_server(
    service: SearchService, host: str = "127.0.0.1", port: int = 8765
) -> ThreadingHTTPServer:
    """Bound, ready server — the caller runs ``serve_forever()`` (the
    CLI) or drives it from a thread (tests, chip_smoke.py)."""
    return ThreadingHTTPServer((host, port), make_handler(service))
