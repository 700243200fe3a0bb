"""HTTP handler: the REST surface of one node.

Port of the public routes of pilosa_tpu/server/handler.py that the slice
serves, with the reference's status codes and bodies:

    GET    /  /version  /info  /status  /hosts
    POST   /recalculate-caches
    GET    /index  /schema             (both {"indexes": schema})
    POST   /schema                     (create what does not exist)
    POST   /index/{index}
    GET    /index/{index}
    DELETE /index/{index}
    POST   /index/{index}/field/{field}
    DELETE /index/{index}/field/{field}
    POST   /index/{index}/field/{field}/import
    POST   /index/{index}/field/{field}/import-value
    POST   /index/{index}/field/{field}/import-roaring/{shard}
    POST   /index/{index}/query        (raw PQL or JSON {"query": ...})
    GET    /export?index=&field=&shard=  (text/csv)
    GET    /debug/containers
    GET    /debug/ragged
    GET    /debug/ingest
    GET    /debug/resultcache

``/hosts`` and ``/info`` answer for the one local node, as the reference
does with its cluster off; ``/version`` is the reference's local-only
answer (its update check never runs).

``serialize_result`` is the reference's (handler.py:46), so the JSON of
a query is byte-identical between the two packages.  Built on the
stdlib ThreadingHTTPServer.  Protobuf bodies are not part of the port
yet: the query and import routes refuse one with a 400, with the
reference decoder's message where the body is not protobuf at all
(``_refuse_protobuf``).
"""

from __future__ import annotations

import base64
import datetime as dt
import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from pilosa_tpu_torch.api import API, ApiError, ConflictError, NotFoundError
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.index import IndexOptions
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.parallel.results import (GroupCount, Pair, PairField,
                                               ValCount)

#: largest accepted request body
MAX_REQUEST_BYTES = 256 << 20


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    """One protobuf varint (pilosa_tpu/proto.py:45)."""
    n = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _refuse_protobuf(req, body: bytes) -> None:
    """A body sent as ``application/x-protobuf`` is refused, never read
    as PQL or JSON.  The reference decodes it (pilosa_tpu/proto.py:204);
    a body that breaks the wire format gets that decoder's error, and a
    well-formed message the port's own, since it has no protobuf
    schemas yet."""
    if "protobuf" not in req.headers.get("Content-Type", ""):
        return
    i = 0
    while i < len(body):
        tag, i = _read_varint(body, i)
        wire = tag & 7
        if wire == 0:
            _, i = _read_varint(body, i)
        elif wire == 1:
            if i + 8 > len(body):
                raise ValueError("truncated fixed64")
            i += 8
        elif wire == 2:
            ln, i = _read_varint(body, i)
            if i + ln > len(body):
                raise ValueError("truncated length-delimited field")
            i += ln
        elif wire == 5:
            if i + 4 > len(body):
                raise ValueError("truncated fixed32")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    raise ApiError("protobuf bodies are not supported by this port yet")


def _parse_ts(t):
    """An import timestamp: unix seconds or nanoseconds, or an ISO-8601
    string (pilosa_tpu/server/handler.py:1882)."""
    if isinstance(t, (int, float)):
        if t > 1 << 40:
            t = t / 1e9
        return dt.datetime.fromtimestamp(t, dt.timezone.utc).replace(
            tzinfo=None)
    return dt.datetime.fromisoformat(str(t).replace("Z", ""))


def serialize_result(res):
    """Query result -> JSON-able value (pilosa_tpu/server/handler.py:46,
    for the result types this port returns): a Row, TopN's Pairs,
    Sum/Min/Max's ValCount, GroupBy's GroupCounts, Rows' ids, a count or
    a write's bool."""
    if isinstance(res, Row):
        out = {}
        if res.exclude_columns:
            pass
        elif res.keys:
            out["keys"] = list(res.keys)
        else:
            out["columns"] = [int(c) for c in res.columns()]
        if res.attrs:
            out["attrs"] = res.attrs
        return out
    if isinstance(res, Pair):
        return _pair_dict(res)
    if isinstance(res, PairField):
        return _pair_dict(res.pair)
    if isinstance(res, ValCount):
        return {"value": int(res.val), "count": int(res.count)}
    if isinstance(res, GroupCount):
        return {
            "group": [_field_row_dict(fr) for fr in res.group],
            "count": int(res.count),
        }
    if isinstance(res, list):
        return [serialize_result(r) for r in res]
    if isinstance(res, np.integer):
        return int(res)
    if isinstance(res, (bool, int, str)) or res is None:
        return res
    raise TypeError(f"unserializable result type: {type(res)!r}")


def _pair_dict(p: Pair) -> dict:
    d = {"count": int(p.count)}
    if p.key:
        d["key"] = p.key
    else:
        d["id"] = int(p.id)
    return d


def _field_row_dict(fr) -> dict:
    d = {"field": fr.field}
    if fr.row_key:
        d["rowKey"] = fr.row_key
    else:
        d["rowID"] = int(fr.row_id)
    if fr.value is not None:
        d["value"] = int(fr.value)
    return d


# (method, compiled path regex, handler-method name)
_ROUTES: list[tuple[str, re.Pattern, str]] = []


def route(method: str, pattern: str):
    """Register a route; ``{name}`` segments capture path params."""
    rx = re.compile(
        "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")

    def deco(fn):
        _ROUTES.append((method, rx, fn.__name__))
        return fn

    return deco


class Handler:
    """Routes HTTP requests to an API and serves on a background
    thread."""

    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 0):
        self.api = api
        handler_self = self

        class _Req(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            timeout = 60  # per-connection read timeout

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                handler_self._handle(self, "GET")

            def do_POST(self):
                handler_self._handle(self, "POST")

            def do_DELETE(self):
                handler_self._handle(self, "DELETE")

        class _Srv(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self.httpd = _Srv((host, port), _Req)
        self.httpd.block_on_close = False
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def uri(self) -> str:
        return f"http://{self.host}:{self.port}"

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------ plumbing

    def _handle(self, req: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for m, rx, name in _ROUTES:
            match = rx.match(path) if m == method else None
            if match is None:
                continue
            try:
                length = int(req.headers.get("Content-Length") or 0)
                if length > MAX_REQUEST_BYTES:
                    req.close_connection = True
                    self._error(req, 413, f"request body exceeds "
                                          f"{MAX_REQUEST_BYTES} bytes")
                    return
                body = req.rfile.read(length) if length else b""
                getattr(self, name)(req, params, match.groupdict(), body)
            except NotFoundError as e:
                self._error(req, 404, str(e))
            except ConflictError as e:
                self._error(req, 409, str(e))
            except (ApiError, ValueError, KeyError, TypeError) as e:
                self._error(req, 400, str(e))
            except Exception as e:  # noqa: BLE001 -- keep serving
                self._error(req, 500, f"{type(e).__name__}: {e}")
            return
        self._error(req, 404, "not found")

    def _json(self, req, obj, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        req.send_response(status)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _bytes(self, req, data: bytes, ctype: str) -> None:
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _error(self, req, status: int, msg: str) -> None:
        try:
            self._json(req, {"error": msg}, status)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # -------------------------------------------------------------- routes

    @route("GET", "/")
    def handle_root(self, req, params, path, body):
        self._json(req, {
            "name": "pilosa-tpu",
            "version": self.api.version(),
            "docs": "see /schema, /status, /index/{index}/query",
        })

    @route("GET", "/version")
    def handle_version(self, req, params, path, body):
        # the reference's update check with no fetcher wired: local only
        # (pilosa_tpu/diagnostics.py:69-80)
        self._json(req, {"version": self.api.version(),
                         "updateCheck": "disabled (local-only diagnostics; "
                                        "wire a fetcher to enable)"})

    @route("GET", "/info")
    def handle_info(self, req, params, path, body):
        self._json(req, self.api.info())

    @route("GET", "/status")
    def handle_status(self, req, params, path, body):
        self._json(req, {
            "state": self.api.state(),
            "nodes": self.api.hosts(),
            "localID": self.api.holder.node_id,
        })

    @route("GET", "/hosts")
    def handle_hosts(self, req, params, path, body):
        self._json(req, self.api.hosts())

    @route("POST", "/recalculate-caches")
    def handle_recalculate_caches(self, req, params, path, body):
        self.api.recalculate_caches()
        self._json(req, {})

    @route("GET", "/index")
    def handle_get_indexes(self, req, params, path, body):
        self._json(req, {"indexes": self.api.schema()})

    @route("GET", "/schema")
    def handle_get_schema(self, req, params, path, body):
        self._json(req, {"indexes": self.api.schema()})

    @route("POST", "/schema")
    def handle_post_schema(self, req, params, path, body):
        d = json.loads(body or b"{}")
        self.api.apply_schema(d.get("indexes", []))
        self._json(req, {})

    @route("GET", "/export")
    def handle_export(self, req, params, path, body):
        buf = io.StringIO()
        self.api.export_csv(params["index"], params["field"],
                            int(params.get("shard", 0)), buf)
        self._bytes(req, buf.getvalue().encode(), "text/csv")

    @route("GET", "/debug/containers")
    def handle_debug_containers(self, req, params, path, body):
        """The [containers] config in force and the container.* counters,
        with the reference's keys (pilosa_tpu/server/handler.py:1372)."""
        from pilosa_tpu_torch.ops import containers

        self._json(req, containers.debug())

    @route("POST", "/index/{index}/query")
    def handle_post_query(self, req, params, path, body):
        _refuse_protobuf(req, body)
        pql = body.decode()
        if "json" in req.headers.get("Content-Type", ""):
            pql = json.loads(pql).get("query", "")
        shards = None
        if params.get("shards"):
            shards = [int(s) for s in params["shards"].split(",")]
        exclude_columns = params.get("excludeColumns") == "true"
        results = self.api.query(
            path["index"], pql, shards=shards,
            exclude_columns=exclude_columns,
            containers=params.get("nocontainers") not in ("1", "true"),
            # ?nocoalesce=true: no cross-query batching for this request
            coalesce=params.get("nocoalesce") != "true",
            # ?novm=1: coalesced sparse Counts take the dense engines
            vm=params.get("novm") not in ("1", "true"),
            # ?nodelta=1: compact pending ingest deltas up front and read
            # pure base state (pilosa_tpu/server/handler.py:779-782)
            delta=params.get("nodelta") not in ("1", "true"),
            # ?nocache=1: a real execution, no result-cache probe or fill
            # (pilosa_tpu/server/handler.py:776-778)
            cache=params.get("nocache") not in ("1", "true"))
        if exclude_columns:
            for r in results:
                if isinstance(r, Row):
                    r.exclude_columns = True
        resp = {"results": [serialize_result(r) for r in results]}
        # ?columnAttrs=true, or Options(columnAttrs=true) around a Row:
        # the reference adds the result columns' attribute sets
        # (pilosa_tpu/server/handler.py:823-845).  The port keeps no
        # column attributes, so the list is always empty.
        if params.get("columnAttrs") == "true" or any(
                isinstance(r, Row) and r.wants_column_attrs for r in results):
            resp["columnAttrs"] = []
        # ?partial=1 or X-Pilosa-Partial: the degraded-read meta, always
        # present on such a request (pilosa_tpu/server/handler.py:
        # 756-758, 846-853).  One node misses no shard.
        if (params.get("partial") in ("1", "true")
                or req.headers.get("X-Pilosa-Partial") in ("1", "true")):
            resp["missingShards"] = []
            resp["missingFraction"] = 0.0
        self._json(req, resp)

    @route("GET", "/debug/ragged")
    def handle_debug_ragged(self, req, params, path, body):
        """Ragged megabatch state (ops/tape.py, parallel/coalescer.py),
        with the reference's keys (pilosa_tpu/server/handler.py:1387):
        the tape.* / coalescer.shape_* / vm.* counters, the program
        variants run, the VM's per-reason fallbacks, and the coalescer
        knobs in force."""
        from pilosa_tpu_torch.ops import tape

        out = tape.debug()
        co = self.api.executor.coalescer
        out["coalescer"] = {"attached": co is not None}
        if co is not None:
            out["coalescer"].update({
                "enabled": co.enabled,
                "ragged": co.ragged,
                "maxTape": co.max_tape,
                "maxLeaves": co.max_leaves,
                "windowMs": co.window_s * 1e3,
                "maxBatch": co.max_batch,
                "vm": co.vm,
                "vmMinDomain": co.vm_min_domain,
                "vmMaxPrefetch": co.vm_max_prefetch,
            })
        self._json(req, out)

    @route("GET", "/debug/ingest")
    def handle_debug_ingest(self, req, params, path, body):
        """Streaming-ingest state with the reference's keys
        (pilosa_tpu/server/handler.py:1361): the [ingest] config in
        force, the pending-delta totals, the compaction counters and the
        largest pending deltas."""
        from pilosa_tpu_torch.ingest import compactor

        self._json(req, compactor.compactor().debug())

    @route("GET", "/debug/resultcache")
    def handle_debug_resultcache(self, req, params, path, body):
        """Result-cache state with the reference's keys
        (pilosa_tpu/server/handler.py:1350): budget, bytes and entries,
        the hit / miss / fill / eviction / invalidation / flight totals,
        and the largest entries."""
        from pilosa_tpu_torch.runtime import resultcache

        self._json(req, resultcache.cache().debug())

    @route("POST", "/index/{index}")
    def handle_create_index(self, req, params, path, body):
        d = json.loads(body or b"{}")
        self.api.create_index(path["index"],
                              IndexOptions.from_dict(d.get("options", {})))
        self._json(req, {})

    @route("DELETE", "/index/{index}")
    def handle_delete_index(self, req, params, path, body):
        self.api.delete_index(path["index"])
        self._json(req, {})

    @route("GET", "/index/{index}")
    def handle_get_index(self, req, params, path, body):
        idx = self.api.index(path["index"])
        self._json(req, {"name": idx.name, "options": idx.options.to_dict()})

    @route("POST", "/index/{index}/field/{field}")
    def handle_create_field(self, req, params, path, body):
        d = json.loads(body or b"{}")
        self.api.create_field(path["index"], path["field"],
                              FieldOptions.from_dict(d.get("options", {})))
        self._json(req, {})

    @route("DELETE", "/index/{index}/field/{field}")
    def handle_delete_field(self, req, params, path, body):
        self.api.delete_field(path["index"], path["field"])
        self._json(req, {})

    @route("POST", "/index/{index}/field/{field}/import")
    def handle_import(self, req, params, path, body):
        """JSON {"rowIDs": [...], "columnIDs": [...], "timestamps":
        [...]}: unix seconds or nanoseconds, or ISO-8601 strings, each
        bit written to its time views too; into a field with no time
        quantum they are checked and the standard view written, as in
        the reference (pilosa_tpu/server/handler.py:960-964)."""
        _refuse_protobuf(req, body)
        d = json.loads(body)
        timestamps = d.get("timestamps")
        if timestamps:
            timestamps = [None if t is None else _parse_ts(t)
                          for t in timestamps]
        self.api.import_bits(path["index"], path["field"],
                             d.get("rowIDs") or [], d.get("columnIDs") or [],
                             timestamps=timestamps,
                             row_keys=d.get("rowKeys"),
                             col_keys=d.get("columnKeys"),
                             clear=params.get("clear") == "true")
        self._json(req, {})

    @route("POST", "/index/{index}/field/{field}/import-value")
    def handle_import_value(self, req, params, path, body):
        """JSON {"columnIDs": [...], "values": [...]}
        (pilosa_tpu/server/handler.py:976)."""
        _refuse_protobuf(req, body)
        d = json.loads(body)
        self.api.import_values(path["index"], path["field"],
                               d.get("columnIDs") or [],
                               d.get("values") or [],
                               col_keys=d.get("columnKeys"))
        self._json(req, {})

    @route("POST", "/index/{index}/field/{field}/import-roaring/{shard}")
    def handle_import_roaring(self, req, params, path, body):
        """Raw roaring bytes for the standard view, or JSON
        {"views": {name: base64}}."""
        _refuse_protobuf(req, body)
        if "json" in req.headers.get("Content-Type", ""):
            d = json.loads(body)
            views = {k: base64.b64decode(v)
                     for k, v in (d.get("views") or {}).items()}
        else:
            views = {"": body}
        self.api.import_roaring(path["index"], path["field"],
                                int(path["shard"]), views,
                                clear=params.get("clear") == "true")
        self._json(req, {})
