"""Server: one node's holder, executor, coalescer, API and HTTP handler.

Port of the single-node assembly of pilosa_tpu/server/server.py.  The
node runs on ``cuda`` unless the caller passes ``device="cpu"``; asking
for ``cuda`` without a card raises at construction.

The coalescer knobs and their defaults are the reference's
(``[coalescer]``, ``[ragged]`` and ``[vm]``, pilosa_tpu/config.py:166-221;
server.py:235-250).  ``coalescer_enabled="auto"`` turns batching on
when the node runs on a CUDA card.

The ``[containers]`` kind knobs ``containers_kinds``,
``containers_array_max`` and ``containers_run_cap`` (server.py:94-96)
are process-wide, as in the reference: ``open`` takes a reference on the
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
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch import ingest
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.ingest import compactor
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import containers, tape
from pilosa_tpu_torch.parallel.coalescer import Coalescer
from pilosa_tpu_torch.parallel.executor import Executor
from pilosa_tpu_torch.runtime import resultcache
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
                 vm_enabled: bool = True,
                 vm_min_domain: int = containers.VM_MIN_DOMAIN,
                 vm_max_prefetch: int = containers.VM_MAX_PREFETCH,
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
                 tenants_quotas: dict | None = None):
        self.device = devmod.resolve(device)
        self.data_dir = data_dir
        self.host = host
        self.port = port
        # built here, so a bad knob raises before anything opens
        self.coalescer = Coalescer(
            window_s=coalescer_window_ms / 1e3,
            max_batch=coalescer_max_batch, enabled=coalescer_enabled,
            device=self.device, ragged=ragged_enabled,
            max_tape=ragged_max_tape, max_leaves=ragged_max_leaves,
            vm=vm_enabled, vm_min_domain=vm_min_domain,
            vm_max_prefetch=vm_max_prefetch)
        self._containers_knobs = {"kinds": containers_kinds,
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
        self._closed = False
        containers.retain()
        self._containers_retained = True
        containers.configure(**self._containers_knobs)
        try:
            self.holder = Holder(self.data_dir, device=self.device)
            self.executor = Executor(self.holder, device=self.device)
            self.executor.coalescer = self.coalescer
            self.api = API(self.holder, self.executor)
            self.handler = Handler(self.api, self.host, self.port,
                                   admission=self.admission)
            self.api.uri = self.handler.uri
        except BaseException:
            if self.holder is not None:
                self.holder.close()
                self.holder = None
            self._release_containers()
            raise
        # the compactor's scans run under the internal class (the
        # compactor is process-wide: the last server opened gates it)
        compactor.compactor().admission = self.admission
        self.handler.serve_background()
        return self

    def close(self) -> None:
        if self._closed:
            # idempotent: a second close must not release the shared
            # compactor reference under a still-open sibling
            return
        self._closed = True
        if self.handler is not None:
            self.handler.close()
            self.handler = None
        if self.holder is not None:
            self.holder.close()
            self.holder = None
        c = compactor.compactor()
        if c.admission is self.admission:
            c.admission = None
        self._release_containers()
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
