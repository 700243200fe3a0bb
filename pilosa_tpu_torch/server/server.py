"""Server: one node's holder, executor, coalescer, API and HTTP handler.

Port of the single-node assembly of pilosa_tpu/server/server.py.  The
node runs on ``cuda`` unless the caller passes ``device="cpu"``; asking
for ``cuda`` without a card raises at construction.

The coalescer knobs and their defaults are the reference's
(``[coalescer]``, ``[ragged]`` and ``[vm]``, pilosa_tpu/config.py:166-221;
server.py:235-250).  ``coalescer_enabled="auto"`` turns batching on
when the node runs on a CUDA card.

The ``[containers]`` knobs ``containers_enabled``,
``containers_threshold``, ``containers_kinds``, ``containers_array_max``
and ``containers_run_cap`` (server.py:92-96) are process-wide, as in the
reference: ``open`` takes a reference on the
config (the first one snapshots the config in force) and applies the
knobs given; ``close`` gives it back, and the last one restores the
snapshot.  ``None`` keeps the value in force (default: kinds on).

The ``[ingest]`` knobs ``ingest_delta_enabled`` (default true, as
``[ingest] delta-enabled``), ``ingest_delta_budget_bytes``,
``ingest_compact_threshold_bits`` and ``ingest_compact_interval``
(server.py:88-91) are process-wide too: the first server constructed
captures the config in force, each applies its knobs, an ingest-enabled
server takes a reference on the compactor's scan thread at construction
(pilosa_tpu_torch/ingest/compactor.retain) and gives it back on close,
and the last closer restores the captured config
(pilosa_tpu/server/server.py:288-311, 382-391, 716-735).

The ``[cache]`` knobs ``cache_enabled`` (default true, as ``[cache]
enabled``), ``cache_budget_bytes``, ``cache_max_entry_bytes`` and
``cache_ttl`` (server.py:84-87, 276-290) configure the process-wide
result cache (runtime/resultcache.py) in place, so a second server in
the process keeps the first's warm entries.  The server takes a
reference at construction, where its knobs land, and gives it back on
close; the last closer restores the knobs the first one found.

Admission (``[admission]``, on by default as in the reference;
server.py:76-83, 407-428): the ``admission_*`` knobs build the server's
``serve.admission.AdmissionController``, which the HTTP handler gates
its query and ingest routes with and the process-wide compactor runs its
scans under (``internal``).  ``admission_enabled=False`` turns the gate,
its shedding and the handler's thread cap off.

The ``[tenants]`` knobs ``tenants_enabled`` (default false),
``tenants_default_share``, ``tenants_default_queue``,
``tenants_default_cache_share``, ``tenants_default_residency_share`` and
``tenants_quotas`` (server.py:127-132, 347-364) are process-wide: the
server takes a reference at construction, where its knobs land, and
gives it back on close; the last closer restores the config the first
one found, and a reopened server applies its knobs again.
``close`` is idempotent.

Residency (``[residency]``, on by default as in the reference;
server.py:99-106, 365-381, 429-436, 500-507, 754-756): the
``residency_*`` knobs configure the process-wide tiered residency
manager (runtime/residency.py) in place; the server takes a reference at
construction (the first one snapshots the config in force) and gives it
back on close, and the last closer restores the snapshot and stops the
promotion workers.  ``open`` gates the promotion pool with the server's
admission controller (``internal``) and starts a ``Prefetcher``, which
``close`` stops.  The HBM budget itself is the manager's
(``PILOSA_TPU_DEVICE_BUDGET_BYTES``, else 60 % of the card's memory).

``ragged_prewarm`` (``[ragged] prewarm``, default true; server.py:
582-624): on a CUDA node whose coalescer runs the VM, ``open`` starts a
background thread that loads every CUDA kernel (building a missing one
with nvcc) and launches K3 once per batch of the smallest size class's
pow2 ladder (``ops/tape.prewarm``).  It is best-effort: a failure is
logged as the reference logs it and counted in
``ragged_prewarm_stats``, and the first query then pays the load; no
kernel is ever replaced by its plain version.  ``close`` waits for the
thread.

``max_writes_per_request`` (default 0, no limit; server.py:46, 406)
caps the write calls of one query request.  ``long_query_time`` (seconds,
0 off) and ``logger`` (default ``logger.NOP``) give the executor the
slow-query log of ``[cluster] long-query-time`` (server.py:134-139,
219-220).
"""

from __future__ import annotations

import threading
import time

import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch import ingest
from pilosa_tpu_torch import logger as _logger
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.ingest import compactor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import containers, cuda_kernels, tape
from pilosa_tpu_torch.parallel.coalescer import Coalescer
from pilosa_tpu_torch.parallel.executor import Executor
from pilosa_tpu_torch.runtime import residency, resultcache
from pilosa_tpu_torch.runtime.prefetch import Prefetcher
from pilosa_tpu_torch.serve import tenant as _tenantcfg
from pilosa_tpu_torch.serve.admission import AdmissionController
from pilosa_tpu_torch.server.handler import Handler


class Server:
    def __init__(self, data_dir: str, host: str = "127.0.0.1", port: int = 0,
                 device: str | torch.device | None = None,
                 coalescer_enabled="auto", coalescer_window_ms: float = 2.0,
                 coalescer_max_batch: int = 32, ragged_enabled: bool = True,
                 ragged_max_tape: int = tape.DEFAULT_MAX_TAPE,
                 ragged_max_leaves: int = tape.DEFAULT_MAX_LEAVES,
                 ragged_prewarm: bool = True,
                 vm_enabled: bool = True,
                 vm_min_domain: int = containers.VM_MIN_DOMAIN,
                 vm_max_prefetch: int = containers.VM_MAX_PREFETCH,
                 containers_enabled: bool | None = None,
                 containers_threshold: float | None = None,
                 containers_kinds: bool | None = None,
                 containers_array_max: int | None = None,
                 containers_run_cap: int | None = None,
                 cache_enabled: bool = True,
                 cache_budget_bytes: int | None = None,
                 cache_max_entry_bytes: int | None = None,
                 cache_ttl: float | None = None,
                 ingest_delta_enabled: bool = True,
                 ingest_delta_budget_bytes: int | None = None,
                 ingest_compact_threshold_bits: int | None = None,
                 ingest_compact_interval: float | None = None,
                 admission_enabled: bool = True,
                 admission_query_cap: int = 32,
                 admission_query_queue: int = 128,
                 admission_ingest_cap: int = 16,
                 admission_ingest_queue: int = 64,
                 admission_internal_cap: int = 16,
                 admission_internal_queue: int = 64,
                 admission_default_deadline: float = 0.0,
                 tenants_enabled: bool = False,
                 tenants_default_share: int | None = None,
                 tenants_default_queue: int | None = None,
                 tenants_default_cache_share: float | None = None,
                 tenants_default_residency_share: float | None = None,
                 tenants_quotas: dict | None = None,
                 residency_host_budget_bytes: int | None = None,
                 residency_disk_path: str | None = None,
                 residency_disk_budget_bytes: int | None = None,
                 residency_promote_workers: int | None = None,
                 residency_promote_queue: int | None = None,
                 residency_promote_wait_ms: float | None = None,
                 residency_prefetch: bool | None = None,
                 residency_prefetch_interval: float | None = None,
                 max_writes_per_request: int = 0,
                 long_query_time: float = 0.0,
                 logger=None):
        self.device = devmod.resolve(device)
        self.data_dir = data_dir
        self.host = host
        self.port = port
        self.logger = logger or _logger.NOP
        self.long_query_time = long_query_time
        self.max_writes_per_request = max_writes_per_request
        # built here, so a bad knob raises before anything opens
        self.coalescer = Coalescer(
            window_s=coalescer_window_ms / 1e3,
            max_batch=coalescer_max_batch, enabled=coalescer_enabled,
            device=self.device, ragged=ragged_enabled,
            max_tape=ragged_max_tape, max_leaves=ragged_max_leaves,
            vm=vm_enabled, vm_min_domain=vm_min_domain,
            vm_max_prefetch=vm_max_prefetch)
        self._containers_knobs = {"enabled": containers_enabled,
                                  "threshold": containers_threshold,
                                  "kinds": containers_kinds,
                                  "array_max": containers_array_max,
                                  "run_cap": containers_run_cap}
        self._containers_retained = False
        self.admission = AdmissionController(
            query_cap=admission_query_cap,
            query_queue=admission_query_queue,
            ingest_cap=admission_ingest_cap,
            ingest_queue=admission_ingest_queue,
            internal_cap=admission_internal_cap,
            internal_queue=admission_internal_queue,
            default_deadline=admission_default_deadline,
            enabled=admission_enabled)
        self._tenants_knobs = dict(
            enabled=tenants_enabled,
            default_share=tenants_default_share,
            default_queue=tenants_default_queue,
            default_cache_share=tenants_default_cache_share,
            default_residency_share=tenants_default_residency_share,
            quotas=tenants_quotas)
        _tenantcfg.retain()
        self._tenants_retained = True
        try:
            _tenantcfg.configure(**self._tenants_knobs)
        except BaseException:
            self._tenants_retained = False
            _tenantcfg.release()
            raise
        self._residency_knobs = dict(
            host_budget_bytes=residency_host_budget_bytes,
            disk_path=residency_disk_path,
            disk_budget_bytes=residency_disk_budget_bytes,
            promote_workers=residency_promote_workers,
            promote_queue=residency_promote_queue,
            promote_wait_ms=residency_promote_wait_ms,
            prefetch=residency_prefetch,
            prefetch_interval=residency_prefetch_interval)
        residency.retain()
        self._residency_retained = True
        residency.configure(**self._residency_knobs)
        self.prefetcher = Prefetcher()
        self.ragged_prewarm = bool(ragged_prewarm)
        self._ragged_thread = None
        #: the last open's [ragged] prewarm: K3 launches made, failures,
        #: seconds, and whether it has finished
        self.ragged_prewarm_stats: dict = {}
        self._cache_knobs = {"budget_bytes": cache_budget_bytes,
                             "max_entry_bytes": cache_max_entry_bytes,
                             "ttl_s": cache_ttl, "enabled": cache_enabled}
        resultcache.retain()
        self._cache_retained = True
        resultcache.configure(**self._cache_knobs)
        ingest.capture_baseline()
        ingest.configure(delta_enabled=ingest_delta_enabled,
                         delta_budget_bytes=ingest_delta_budget_bytes,
                         compact_threshold_bits=ingest_compact_threshold_bits,
                         compact_interval=ingest_compact_interval)
        self._ingest_enabled = bool(ingest_delta_enabled)
        self._ingest_retained = False
        if self._ingest_enabled:
            # taken at construction, where the configure above landed, so
            # a sibling's close cannot restore the baseline under a
            # constructed but not yet opened server
            compactor.retain()
            self._ingest_retained = True
        self._closed = False
        self.holder: Holder | None = None
        self.executor: Executor | None = None
        self.api: API | None = None
        self.handler: Handler | None = None

    @property
    def uri(self) -> str:
        return self.handler.uri

    def open(self) -> "Server":
        """Open the data directory and start serving HTTP."""
        if self._ingest_enabled and not self._ingest_retained:
            # reopened after close: take the compactor reference back
            compactor.retain()
            self._ingest_retained = True
        if not self._cache_retained:
            resultcache.retain()
            self._cache_retained = True
            resultcache.configure(**self._cache_knobs)
        if not self._tenants_retained:
            _tenantcfg.retain()
            self._tenants_retained = True
            _tenantcfg.configure(**self._tenants_knobs)
        if not self._residency_retained:
            residency.retain()
            self._residency_retained = True
            residency.configure(**self._residency_knobs)
        self._closed = False
        containers.retain()
        self._containers_retained = True
        containers.configure(**self._containers_knobs)
        try:
            self.holder = Holder(self.data_dir, device=self.device)
            self.executor = Executor(self.holder, device=self.device)
            self.executor.coalescer = self.coalescer
            self.executor.logger = self.logger
            self.executor.long_query_time = self.long_query_time
            self.api = API(self.holder, self.executor)
            self.api.max_writes_per_request = self.max_writes_per_request
            self.handler = Handler(self.api, self.host, self.port,
                                   admission=self.admission)
            self.api.uri = self.handler.uri
        except BaseException:
            if self.holder is not None:
                self.holder.close()
                self.holder = None
            self._release_containers()
            raise
        # the compactor's scans and the residency promotions run under
        # the internal class (both are process-wide: the last server
        # opened gates them)
        compactor.compactor().admission = self.admission
        residency.promoter().admission = self.admission
        self.prefetcher.start()
        self.handler.serve_background()
        co = self.coalescer
        self.ragged_prewarm_stats = {"launches": 0, "failures": 0,
                                     "seconds": 0.0, "done": False}
        if (self.ragged_prewarm and self.device.type == "cuda"
                and co.enabled and co.ragged and co.vm):
            self._ragged_thread = threading.Thread(
                target=self._prewarm_ragged, daemon=True,
                name="ragged-prewarm")
            self._ragged_thread.start()
        return self

    def _prewarm_ragged(self) -> None:
        st = self.ragged_prewarm_stats
        t0 = time.perf_counter()
        try:
            cuda_kernels.load_all()
            st["launches"] = tape.prewarm(self.device,
                                          self.coalescer.max_batch)
            torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001 -- never breaks serving;
            # the first coalesced query pays the load instead
            st["failures"] += 1
            self.logger.printf("ragged prewarm skipped: %r", e)
        finally:
            st["seconds"] = time.perf_counter() - t0
            st["done"] = True

    def close(self) -> None:
        if self._closed:
            # idempotent: a second close must not release the shared
            # compactor reference under a still-open sibling
            return
        self._closed = True
        self.prefetcher.stop()
        if self._ragged_thread is not None:
            self._ragged_thread.join(timeout=300)
            self._ragged_thread = None
        if self.handler is not None:
            self.handler.close()
            self.handler = None
        if self.holder is not None:
            self.holder.close()
            self.holder = None
        c = compactor.compactor()
        if c.admission is self.admission:
            c.admission = None
        p = residency.promoter()
        if p.admission is self.admission:
            p.admission = None
        self._release_containers()
        if self._residency_retained:
            self._residency_retained = False
            residency.release()
        if self._tenants_retained:
            self._tenants_retained = False
            _tenantcfg.release()
        if self._cache_retained:
            self._cache_retained = False
            resultcache.release()
        if self._ingest_retained:
            self._ingest_retained = False
            last = compactor.release()
        else:
            # an ingest-disabled server restores only when no
            # ingest-enabled sibling still holds a reference
            last = compactor.refs() == 0
        if last:
            ingest.restore_baseline()

    def _release_containers(self) -> None:
        if self._containers_retained:
            self._containers_retained = False
            containers.release()
