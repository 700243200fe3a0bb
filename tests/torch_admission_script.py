"""A scripted runner of an admission controller, and the HTTP helpers of
a server pair, for the tests that hold the port's admission, deadlines
and tenants against the JAX package's (tests/test_torch_admission.py,
tests/test_torch_tenants.py).

One script runs against a controller of each package; every step lands
in a transcript (who was admitted, in which order, and each refusal's
class, reason, status, Retry-After, tenant and message), and the
controller's ``debug()`` is recorded with its timing fields reduced to
whether they are positive.  A queued acquire runs on a thread of its own,
and the script goes on once the class's ``waiting`` count shows it.

``same`` sends one request to a JAX server and a port server and requires
the same status, ``Retry-After`` and body bytes."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

#: the shards of the servers' field f, at the test width
N_SHARDS = 3

#: queries every server pair answers, with and without a tenant
ADMITTED = [b"Count(Row(f=1))", b"Row(f=2)", b"TopN(f, n=3)",
            b"Count(Intersect(Row(f=1), Row(f=3)))", b"Rows(f)",
            b"Set(7, f=9)", b"Count(Row(f=9))"]

_TIMED = ("ewmaServiceMs", "queueWaitEwmaMs")


def scrub(doc):
    """``debug()`` with its timing fields reduced to ``> 0``."""
    if isinstance(doc, dict):
        return {k: (v > 0 if k in _TIMED else scrub(v))
                for k, v in doc.items()}
    return doc


class Runner:
    def __init__(self, adm, dlmod, ctrl):
        self.adm, self.dl, self.ctrl = adm, dlmod, ctrl
        self.tickets: dict = {}
        self.threads: dict = {}
        self.results: dict = {}
        self.order: list = []
        self._seen_order: list = []
        self.log: list = []
        # the package's tenant module, which a script may reconfigure
        self.tenant = adm._tenant
        self._lock = threading.Lock()

    def _deadline(self, budget):
        return None if budget is None else self.dl.Deadline(budget)

    def _record(self, name, out) -> None:
        if isinstance(out, self.adm.ShedError):
            self.log.append((name, "shed", out.klass, out.reason,
                             out.status, out.retry_after, out.tenant,
                             out.outcome, str(out)))
        else:
            self.tickets[name] = out
            self.log.append((name, "admitted", out.klass, out.tenant))

    def acquire(self, name, klass, budget=None, tenant=None) -> None:
        """An acquire on the script's thread (it must not queue)."""
        try:
            out = self.ctrl.acquire(klass, self._deadline(budget),
                                    tenant=tenant)
        except self.adm.ShedError as e:
            out = e
        self._record(name, out)

    def try_acquire(self, name, klass) -> None:
        try:
            out = self.ctrl.try_acquire(klass)
        except self.adm.ShedError as e:
            out = e
        self._record(name, out)

    def waiting(self, klass) -> int:
        return self.ctrl.debug()["classes"][klass]["waiting"]

    def queue(self, name, klass, budget=None, tenant=None) -> None:
        """An acquire that queues, on a thread of its own; returns once
        the class counts one more waiter."""
        before = self.waiting(klass)
        dl = self._deadline(budget)

        def run():
            try:
                out = self.ctrl.acquire(klass, dl, tenant=tenant)
                with self._lock:
                    self.order.append(name)
            except self.adm.ShedError as e:
                out = e
            self.results[name] = out

        t = threading.Thread(target=run, daemon=True)
        self.threads[name] = t
        t.start()
        end = time.monotonic() + 10
        while self.waiting(klass) <= before and t.is_alive():
            assert time.monotonic() < end, f"{name} never queued"
            time.sleep(0.002)

    def admit_next(self, release: bool = True) -> None:
        """Wait for the next queued acquire the controller admits and
        record it; with ``release``, free its slot at once.  A script
        keeps at most one admission outstanding at a time, so that the
        order the waiters' threads record is the controller's."""
        end = time.monotonic() + 10
        n = len(self._seen_order)
        while len(self.order) <= n:
            assert time.monotonic() < end, "no waiter was admitted"
            time.sleep(0.002)
        name = self.order[n]
        self._seen_order.append(name)
        self.join(name)
        if release:
            self.release(name)

    def join(self, name) -> None:
        """Wait for a queued acquire to end; record how."""
        t = self.threads.pop(name)
        t.join(30)
        assert not t.is_alive(), f"{name} still waits"
        self._record(name, self.results.pop(name))

    def release(self, name) -> None:
        self.tickets.pop(name).release()

    def debug(self) -> None:
        self.log.append(("debug", scrub(self.ctrl.debug())))

    def tenants_debug(self) -> None:
        self.log.append(("tenants", scrub(self.ctrl.tenants_debug())))


def run_both(script, pairs) -> list:
    """The script against each (admission module, deadline module,
    controller); the transcripts and admission orders, one per package."""
    out = []
    for adm, dlmod, ctrl in pairs:
        r = Runner(adm, dlmod, ctrl)
        script(r)
        assert not r.threads, f"unjoined waiters: {sorted(r.threads)}"
        for t in list(r.tickets):
            r.release(t)
        r.debug()
        out.append((r.log, r.order))
    return out


# ------------------------------------------------------- server pairs


def req(uri, path, body=None, headers=None, ctype="text/plain"):
    """(status, Retry-After, body) of one request."""
    r = urllib.request.Request(uri + path, data=body,
                               method="GET" if body is None else "POST")
    if body is not None:
        r.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        r.add_header(k, v)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return (resp.status, resp.headers.get("Retry-After"),
                    resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), e.read()


def same(pair, path, body=None, headers=None, ctype="text/plain"):
    """The same request to both servers: the same status, Retry-After
    and body bytes."""
    want = req(pair[0].uri, path, body, headers, ctype)
    got = req(pair[1].uri, path, body, headers, ctype)
    assert got == want, (path, headers, got, want)
    return want


def setup(pair, shard_width: int) -> None:
    """Index i and field f, 400 seeded bits in rows 1-3 of 3 shards."""
    rng = np.random.default_rng(5)
    cols = rng.choice(N_SHARDS * shard_width, size=400, replace=False)
    rows = rng.integers(1, 4, size=400)
    same(pair, "/index/i", b"{}", ctype="application/json")
    same(pair, "/index/i/field/f", b"{}", ctype="application/json")
    same(pair, "/index/i/field/f/import", json.dumps(
        {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}).encode(),
        ctype="application/json")


def admission_doc(server) -> dict:
    """``GET /debug/admission``, its timing fields scrubbed.  The accept
    threads in use read as at most one (the debug request's own): a
    thread that answered an earlier request counts until its connection
    has closed."""
    st, _ra, body = req(server.uri, "/debug/admission")
    assert st == 200
    doc = scrub(json.loads(body))
    threads = doc.get("acceptThreads")
    if threads is not None:
        threads["active"] = min(threads["active"], 1)
    return doc


def quiet(pair, held: int = 0) -> None:
    """Wait until each server's controller holds exactly ``held`` slots: a
    request's ticket is released after its answer is written, so a client
    may read a debug document before the last release."""
    end = time.monotonic() + 10
    while any(sum(c["inFlight"] for c in s.admission.debug()["classes"]
                  .values()) != held for s in pair):
        assert time.monotonic() < end, "a slot was never released"
        time.sleep(0.002)


def hold(pair, klass: str, n: int = 1, tenant=None) -> list:
    """``n`` slots of ``klass`` taken in each server's own controller."""
    return [s.admission.acquire(klass, tenant=tenant)
            for s in pair for _ in range(n)]


def queued(pair, path, body, ctype, headers=None) -> tuple:
    """The request sent to both servers, each from a thread that waits
    in its server's queue; (threads, results) once both are queued."""
    res: dict = {}
    ts = []
    klass = "ingest" if "import" in path else "query"
    for i, s in enumerate(pair):
        before = s.admission.debug()["classes"][klass]["waiting"]
        t = threading.Thread(target=lambda i=i, s=s: res.__setitem__(
            i, req(s.uri, path, body, headers, ctype)))
        t.start()
        ts.append(t)
        end = time.monotonic() + 10
        while s.admission.debug()["classes"][klass]["waiting"] <= before:
            assert time.monotonic() < end, "the request never queued"
            time.sleep(0.002)
    return ts, res
