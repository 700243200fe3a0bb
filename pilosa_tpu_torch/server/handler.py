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
    POST   /index/{index}/query        (raw PQL, JSON {"query": ...} or
                                        a protobuf QueryRequest)
    POST   /internal/translate/keys    (JSON or protobuf)
    GET    /export?index=&field=&shard=  (text/csv)
    GET    /internal/shards/max  /internal/nodes
    GET    /internal/fragment/nodes?index=&shard=
    GET    /debug/containers
    GET    /debug/ragged
    GET    /debug/ingest
    GET    /debug/resultcache
    GET    /debug/admission
    GET    /debug/tenants

``/hosts``, ``/info``, ``/internal/nodes`` and
``/internal/fragment/nodes`` answer for the one local node, as the
reference does with its cluster off; ``/version`` is the reference's local-only
answer (its update check never runs).

``serialize_result`` is the reference's (handler.py:46), so the JSON of
a query is byte-identical between the two packages.  Built on the
stdlib ThreadingHTTPServer.  The query and import routes negotiate JSON
and protobuf as the reference does (pilosa_tpu/server/handler.py:
677-1018; wire schemas in ``pilosa_tpu_torch.proto``): a body sent as
``application/x-protobuf`` is decoded as the route's message, and an
``Accept`` naming protobuf gets a protobuf answer, a query's error as
``QueryResponse.err`` with status 400.  ``GET /internal/translate/data``,
which feeds replicas, waits for the cluster.

Admission and deadlines (pilosa_tpu/server/handler.py:148-161, 356-544):
each route has an admission class, ``query`` (the query route and
``/export``) or ``ingest`` (the three imports and ``POST
/internal/translate/keys``), or none.  Before the body is read, the
dispatch parses ``X-Pilosa-Deadline`` (a malformed value is 400 and
closes the connection), takes the tenant from ``X-Pilosa-Tenant`` or
``?tenant=``, applies the controller's ``default_deadline`` to a gated
request without one, and acquires a ticket: a shed answers
``{"error", "reason", "class"[, "tenant"]}`` with its status (429 or
503) and ``Retry-After`` and closes the connection.  The handler runs
under the request's deadline scope; ``DeadlineExceededError`` is 503,
counted as an expiry of the ticket's class, and the ticket is released
in ``finally``.  The accept loop caps the handler threads at the gate's
total capacity plus ``ACCEPT_HEADROOM`` and answers a connection past
the cap with a fast raw 503.  Left out with the cluster: the
``X-Pilosa-Class`` re-tag of the internal routes and the remote shed
(``ShedByPeerError``); with the flight recorder: ``record_shed``; with
the stats registry: the ``http.request`` and ``admission.accept_503``
counters.
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

from pilosa_tpu_torch import proto
from pilosa_tpu_torch.api import API, ApiError, ConflictError, NotFoundError
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.index import IndexOptions
from pilosa_tpu_torch.models.row import Row
from pilosa_tpu_torch.parallel.results import (GroupCount, Pair, PairField,
                                               ValCount)
from pilosa_tpu_torch.serve import admission as _admission
from pilosa_tpu_torch.serve import deadline as _deadline
from pilosa_tpu_torch.serve import tenant as _tenant
from pilosa_tpu_torch.serve.deadline import DeadlineExceededError

#: largest accepted request body
MAX_REQUEST_BYTES = 256 << 20


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


# (method, compiled path regex, handler-method name, admission class)
_ROUTES: list[tuple[str, re.Pattern, str, str | None]] = []


def route(method: str, pattern: str, klass: str | None = None):
    """Register a route; ``{name}`` segments capture path params.
    ``klass`` is the route's admission class (``query``, ``ingest``), or
    None for a route the gate leaves alone."""
    rx = re.compile(
        "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")

    def deco(fn):
        _ROUTES.append((method, rx, fn.__name__, klass))
        return fn

    return deco


class Handler:
    """Routes HTTP requests to an API and serves on a background
    thread."""

    #: handler threads allowed above the gate's capacity, for the ungated
    #: routes and idle keep-alive connections (the cap counts
    #: connections, each holding one thread while it lives)
    ACCEPT_HEADROOM = 64

    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 0,
                 admission=None):
        self.api = api
        # the gate between HTTP and the launches
        # (serve/admission.AdmissionController), or None
        self.admission = admission
        # the cap on handler threads: the gate's total capacity plus the
        # headroom; None (no cap) without an enabled gate
        self.max_threads = (
            admission.total_capacity() + self.ACCEPT_HEADROOM
            if admission is not None and admission.enabled else None)
        self._threads_lock = threading.Lock()
        self._threads_active = 0
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

            def process_request(self, request, client_address):
                # past the thread cap, a fast 503 from the accept loop
                # instead of another thread
                if not handler_self._thread_slot_acquire():
                    handler_self._refuse_connection(request)
                    self.shutdown_request(request)
                    return
                try:
                    super().process_request(request, client_address)
                except BaseException:
                    # the worker never started: its release will not run
                    handler_self._thread_slot_release()
                    raise

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request,
                                                   client_address)
                finally:
                    handler_self._thread_slot_release()

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

    # --------------------------------------------------- accept-side cap

    def _thread_slot_acquire(self) -> bool:
        if self.max_threads is None:
            return True
        with self._threads_lock:
            if self._threads_active < self.max_threads:
                self._threads_active += 1
                return True
        return False

    def _thread_slot_release(self) -> None:
        if self.max_threads is None:
            return
        with self._threads_lock:
            self._threads_active -= 1

    _REFUSE_BODY = b'{"error":"server overloaded"}'
    _REFUSE_RESPONSE = (
        b"HTTP/1.1 503 Service Unavailable\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: " + str(len(_REFUSE_BODY)).encode() + b"\r\n"
        b"Retry-After: 1\r\n"
        b"Connection: close\r\n\r\n" + _REFUSE_BODY)

    def _refuse_connection(self, request) -> None:
        """A best-effort raw 503 from the accept loop, with a short
        timeout so that a stalled client cannot hold the accepts."""
        try:
            request.settimeout(1.0)
            request.sendall(self._REFUSE_RESPONSE)
        except OSError:
            pass

    # ------------------------------------------------------------ plumbing

    def _handle(self, req: BaseHTTPRequestHandler, method: str) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for m, rx, name, klass in _ROUTES:
            match = rx.match(path) if m == method else None
            if match is None:
                continue
            # the deadline and the gate come BEFORE the body is read: a
            # shed request does not pay for its upload (its unread body
            # closes the connection, as a 413 does)
            dl_hdr = req.headers.get(_deadline.HEADER)
            dl = None
            if dl_hdr is not None:
                try:
                    dl = _deadline.parse_header(dl_hdr)
                except ValueError:
                    req.close_connection = True
                    self._error(req, 400,
                                f"invalid {_deadline.HEADER} header: "
                                f"{dl_hdr!r}")
                    return
            # the tenant id is an accounting key, never a credential: a
            # malformed one degrades to the default tier, never a 400
            tenant = _tenant.clean(req.headers.get("X-Pilosa-Tenant")
                                   or params.get("tenant"))
            req._pilosa_tenant = tenant
            ticket = None
            if self.admission is not None and klass is not None:
                if dl is None and self.admission.default_deadline > 0:
                    dl = _deadline.Deadline(self.admission.default_deadline)
                try:
                    ticket = self.admission.acquire(klass, dl, tenant=tenant)
                except _admission.ShedError as e:
                    req.close_connection = True
                    body_obj = {"error": str(e), "reason": e.reason,
                                "class": e.klass}
                    if e.tenant is not None:
                        body_obj["tenant"] = e.tenant
                    self._json(req, body_obj, e.status,
                               headers={"Retry-After": str(e.retry_after)})
                    return
            try:
                length = int(req.headers.get("Content-Length") or 0)
                if length > MAX_REQUEST_BYTES:
                    req.close_connection = True
                    self._error(req, 413, f"request body exceeds "
                                          f"{MAX_REQUEST_BYTES} bytes")
                    return
                body = req.rfile.read(length) if length else b""
                with _deadline.scope(dl):
                    getattr(self, name)(req, params, match.groupdict(),
                                        body)
            except NotFoundError as e:
                self._error(req, 404, str(e))
            except ConflictError as e:
                self._error(req, 409, str(e))
            except DeadlineExceededError as e:
                # admitted, then expired in execution: the executor's
                # checks dropped it before any launch
                if ticket is not None:
                    self.admission.count_expired(ticket.klass)
                self._error(req, 503, str(e))
            except (ApiError, ValueError, KeyError, TypeError) as e:
                self._error(req, 400, str(e))
            except Exception as e:  # noqa: BLE001 -- keep serving
                self._error(req, 500, f"{type(e).__name__}: {e}")
            finally:
                if ticket is not None:
                    ticket.release()
            return
        self._error(req, 404, "not found")

    def _json(self, req, obj, status: int = 200,
              headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        req.send_response(status)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            req.send_header(k, v)
        req.end_headers()
        req.wfile.write(data)

    def _bytes(self, req, data: bytes, ctype: str, status: int = 200
               ) -> None:
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _proto(self, req, payload: bytes, status: int = 200) -> None:
        try:
            self._bytes(req, payload, "application/protobuf", status)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _import_ok(self, req) -> None:
        """An import's answer: an empty protobuf ImportResponse when the
        client accepts protobuf, else JSON {} (pilosa_tpu/server/
        handler.py:862-875)."""
        if "protobuf" in req.headers.get("Accept", ""):
            self._proto(req, proto.encode(proto.IMPORT_RESPONSE, {}))
        else:
            self._json(req, {})

    def _error(self, req, status: int, msg: str,
               headers: dict | None = None) -> None:
        try:
            self._json(req, {"error": msg}, status, headers=headers)
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

    @route("GET", "/internal/nodes")
    def handle_internal_nodes(self, req, params, path, body):
        # pilosa_tpu/server/handler.py:664-667
        self._json(req, self.api.hosts())

    @route("GET", "/internal/shards/max")
    def handle_shards_max(self, req, params, path, body):
        # pilosa_tpu/server/handler.py:1034-1036
        self._json(req, {"standard": self.api.shards_max()})

    @route("GET", "/internal/fragment/nodes")
    def handle_fragment_nodes(self, req, params, path, body):
        # pilosa_tpu/server/handler.py:1038-1041: a missing parameter is
        # a KeyError, a bad shard a ValueError, both 400
        self._json(req, self.api.shard_nodes(params["index"],
                                             int(params["shard"])))

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

    @route("GET", "/export", klass="query")
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

    @route("POST", "/internal/translate/keys", klass="ingest")
    def handle_translate_keys(self, req, params, path, body):
        """Keys -> ids, created when new: JSON or protobuf
        TranslateKeysRequest in, the same form out as ``Accept`` asks
        (pilosa_tpu/server/handler.py:677-696)."""
        if "protobuf" in req.headers.get("Content-Type", ""):
            d = proto.decode(proto.TRANSLATE_KEYS_REQUEST, body)
        else:
            d = json.loads(body)
        ids = self.api.translate_keys(d["index"], d.get("field") or None,
                                      d.get("keys") or [], create=True)
        ids = [int(i) for i in ids]
        if "protobuf" in req.headers.get("Accept", ""):
            self._proto(req, proto.encode(proto.TRANSLATE_KEYS_RESPONSE,
                                          {"ids": ids}))
        else:
            self._json(req, {"ids": ids})

    @route("POST", "/index/{index}/query", klass="query")
    def handle_post_query(self, req, params, path, body):
        """PQL in raw text, JSON or a protobuf QueryRequest; the answer
        in protobuf when ``Accept`` asks for it, else JSON
        (pilosa_tpu/server/handler.py:713-860)."""
        ctype = req.headers.get("Content-Type", "")
        proto_accept = "protobuf" in req.headers.get("Accept", "")
        shards = None
        if "protobuf" in ctype:
            preq = proto.decode(proto.QUERY_REQUEST, body)
            pql = preq["query"]
            shards = [int(s) for s in preq["shards"]] or None
            column_attrs = preq["columnAttrs"]
            exclude_row_attrs = preq["excludeRowAttrs"]
            exclude_columns = preq["excludeColumns"]
        else:
            pql = body.decode()
            if "json" in ctype:
                pql = json.loads(pql).get("query", "")
            column_attrs = params.get("columnAttrs") == "true"
            exclude_row_attrs = params.get("excludeRowAttrs") == "true"
            exclude_columns = params.get("excludeColumns") == "true"
        if params.get("shards"):
            shards = [int(s) for s in params["shards"].split(",")]
        # ?partial=1 or X-Pilosa-Partial: the degraded-read meta, on a
        # JSON answer only (pilosa_tpu/server/handler.py:756-758,
        # 846-853).  One node misses no shard.
        partial = (not proto_accept
                   and (params.get("partial") in ("1", "true")
                        or req.headers.get("X-Pilosa-Partial")
                        in ("1", "true")))
        try:
            results = self.api.query(
                path["index"], pql, shards=shards,
                column_attrs=column_attrs,
                exclude_row_attrs=exclude_row_attrs,
                exclude_columns=exclude_columns,
                containers=params.get("nocontainers") not in ("1", "true"),
                # ?nocoalesce=true: no cross-query batching for this
                # request
                coalesce=params.get("nocoalesce") != "true",
                # ?novm=1: coalesced sparse Counts take the dense engines
                vm=params.get("novm") not in ("1", "true"),
                # ?nodelta=1: compact pending ingest deltas up front and
                # read pure base state (pilosa_tpu/server/handler.py:
                # 779-782)
                delta=params.get("nodelta") not in ("1", "true"),
                # ?nocache=1: a real execution, no result-cache probe or
                # fill (pilosa_tpu/server/handler.py:776-778)
                cache=params.get("nocache") not in ("1", "true"),
                # ?notiers=1: bypass tiered residency (host-tier lookups
                # miss, evictions drop; pilosa_tpu/server/handler.py:
                # 792-796)
                tiers=params.get("notiers") not in ("1", "true"),
                # X-Pilosa-Tenant / ?tenant=, cleaned once by the dispatch
                tenant=getattr(req, "_pilosa_tenant", None))
        except Exception as e:  # noqa: BLE001 -- the client's wire form
            if not proto_accept:
                raise
            self._proto(req, proto.encode(proto.QUERY_RESPONSE,
                                          {"err": str(e)}), status=400)
            return
        if exclude_columns:
            for r in results:
                if isinstance(r, Row):
                    r.exclude_columns = True
        # ?columnAttrs=true, or Options(columnAttrs=true) around a Row:
        # the attribute sets of the result columns, present (maybe
        # empty) whenever asked for (pilosa_tpu/server/handler.py:
        # 823-845)
        want_attr_rows = [r for r in results if isinstance(r, Row)
                          and (column_attrs or r.wants_column_attrs)]
        attr_sets = (self._column_attr_sets(path["index"], want_attr_rows)
                     if column_attrs or want_attr_rows else None)
        if proto_accept:
            pb = {"results": [proto.result_to_proto(r) for r in results]}
            if attr_sets is not None:
                pb["columnAttrSets"] = [
                    {"id": a.get("id", 0), "key": a.get("key", ""),
                     "attrs": proto.attrs_to_proto(a["attrs"])}
                    for a in attr_sets]
            self._proto(req, proto.encode(proto.QUERY_RESPONSE, pb))
            return
        resp = {"results": [serialize_result(r) for r in results]}
        if attr_sets is not None:
            resp["columnAttrs"] = attr_sets
        if partial:
            resp["missingShards"] = []
            resp["missingFraction"] = 0.0
        self._json(req, resp)

    def _column_attr_sets(self, index: str, rows: list[Row]) -> list[dict]:
        """The attribute sets of the rows' columns, ascending, each under
        its key in a keyed index (pilosa_tpu/server/handler.py:884-906)."""
        idx = self.api.index(index)
        cols: set[int] = set()
        for r in rows:
            cols.update(int(c) for c in r.columns())
        ordered = sorted(cols)
        attrs_by_id = idx.column_attrs.attrs_bulk(ordered)
        keys_by_id = {}
        if idx.options.keys:
            keys_by_id = dict(zip(ordered,
                                  idx.translate_store.translate_ids(ordered)))
        out = []
        for col in ordered:
            attrs = attrs_by_id.get(col)
            if not attrs:
                continue
            entry = {"attrs": attrs}
            if idx.options.keys:
                entry["key"] = keys_by_id.get(col) or ""
            else:
                entry["id"] = col
            out.append(entry)
        return out

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

    @route("GET", "/debug/admission")
    def handle_debug_admission(self, req, params, path, body):
        """The gate's state with the reference's keys
        (pilosa_tpu/server/handler.py:1758-1771): per class the cap,
        queue depth, in flight, waiting, EWMA service time and the
        admitted / shed / expired totals, and the accept threads."""
        if self.admission is None:
            self._json(req, {"enabled": False})
            return
        out = self.admission.debug()
        out["acceptThreads"] = {
            "active": self._threads_active,
            "max": self.max_threads,
        }
        self._json(req, out)

    @route("GET", "/debug/tenants")
    def handle_debug_tenants(self, req, params, path, body):
        """Per-tenant isolation state with the reference's keys
        (pilosa_tpu/server/handler.py:1773-1813): the [tenants] policy,
        and per tenant the admission totals over the classes, the result
        cache's accounting and the residency manager's (HBM and host-tier
        bytes, the HBM quota, the demotion pressure)."""
        from pilosa_tpu_torch.runtime import residency, resultcache

        cfg = _tenant.config()
        admission = (self.admission.tenants_debug()
                     if self.admission is not None else {})
        cache = resultcache.cache().tenant_stats()
        res = residency.manager().tenant_stats()
        tenants: dict[str, dict] = {}
        for name in sorted(set(admission) | set(cache) | set(res)):
            tenants[name] = {
                "admission": admission.get(name),
                "cache": cache.get(name),
                "residency": res.get(name),
            }
        self._json(req, {
            "enabled": cfg.enabled,
            "default": {
                "share": cfg.default_quota.share,
                "queue": cfg.default_quota.queue,
                "cacheShare": cfg.default_quota.cache_share,
                "residencyShare": cfg.default_quota.residency_share,
            },
            "quotas": {
                n: {"share": q.share, "queue": q.queue,
                    "cacheShare": q.cache_share,
                    "residencyShare": q.residency_share}
                for n, q in cfg.quotas.items()
            },
            "tenants": tenants,
        })

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

    @route("POST", "/index/{index}/field/{field}/import", klass="ingest")
    def handle_import(self, req, params, path, body):
        """JSON {"rowIDs": [...], "columnIDs": [...], "timestamps":
        [...]}: unix seconds or nanoseconds, or ISO-8601 strings, each
        bit written to its time views too; into a field with no time
        quantum they are checked and the standard view written, as in
        the reference (pilosa_tpu/server/handler.py:960-964).  Or a
        protobuf ImportRequest, its timestamps unix nanoseconds, 0 for
        none (pilosa_tpu/server/handler.py:933-975)."""
        if "protobuf" in req.headers.get("Content-Type", ""):
            # large packed id fields stay ndarrays (len(), never truth)
            d = proto.decode(proto.IMPORT_REQUEST, body, arrays=True)
            ts = d.get("timestamps")
            if ts is not None and len(ts):
                d["timestamps"] = [int(t) or None for t in ts]
            # empty repeated fields mean unkeyed, like absent JSON keys
            for k in ("rowKeys", "columnKeys", "timestamps"):
                v = d.get(k)
                if v is None or not len(v):
                    d[k] = None
        else:
            d = json.loads(body)
        timestamps = d.get("timestamps")
        if timestamps:
            timestamps = [None if t is None else _parse_ts(t)
                          for t in timestamps]
        rows_in, cols_in = d.get("rowIDs"), d.get("columnIDs")
        self.api.import_bits(
            path["index"], path["field"],
            rows_in if rows_in is not None and len(rows_in) else [],
            cols_in if cols_in is not None and len(cols_in) else [],
            timestamps=timestamps, row_keys=d.get("rowKeys"),
            col_keys=d.get("columnKeys"),
            clear=params.get("clear") == "true")
        self._import_ok(req)

    @route("POST", "/index/{index}/field/{field}/import-value",
           klass="ingest")
    def handle_import_value(self, req, params, path, body):
        """JSON {"columnIDs": [...], "values": [...], "columnKeys": [...]}
        or a protobuf ImportValueRequest (pilosa_tpu/server/handler.py:
        976-993)."""
        if "protobuf" in req.headers.get("Content-Type", ""):
            d = proto.decode(proto.IMPORT_VALUE_REQUEST, body)
            if not d.get("columnKeys"):
                d["columnKeys"] = None
        else:
            d = json.loads(body)
        self.api.import_values(path["index"], path["field"],
                               d.get("columnIDs") or [],
                               d.get("values") or [],
                               col_keys=d.get("columnKeys"))
        self._import_ok(req)

    @route("POST", "/index/{index}/field/{field}/import-roaring/{shard}",
           klass="ingest")
    def handle_import_roaring(self, req, params, path, body):
        """Raw roaring bytes for the standard view, JSON {"views": {name:
        base64}}, or a protobuf ImportRoaringRequest (pilosa_tpu/server/
        handler.py:994-1018)."""
        ctype = req.headers.get("Content-Type", "")
        clear = params.get("clear") == "true"
        if "protobuf" in ctype:
            d = proto.decode(proto.IMPORT_ROARING_REQUEST, body)
            views = {v["name"]: v["data"] for v in d["views"]}
            clear = clear or d["clear"]
        elif "json" in ctype:
            d = json.loads(body)
            views = {k: base64.b64decode(v)
                     for k, v in (d.get("views") or {}).items()}
        else:
            views = {"": body}
        self.api.import_roaring(path["index"], path["field"],
                                int(path["shard"]), views, clear=clear)
        self._import_ok(req)
