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
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.models.holder import Holder
from pilosa_tpu_torch.ops import containers, tape
from pilosa_tpu_torch.parallel.coalescer import Coalescer
from pilosa_tpu_torch.parallel.executor import Executor
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
                 containers_run_cap: int | None = None):
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
        self.holder: Holder | None = None
        self.executor: Executor | None = None
        self.api: API | None = None
        self.handler: Handler | None = None

    @property
    def uri(self) -> str:
        return self.handler.uri

    def open(self) -> "Server":
        """Open the data directory and start serving HTTP."""
        containers.retain()
        self._containers_retained = True
        containers.configure(**self._containers_knobs)
        try:
            self.holder = Holder(self.data_dir, device=self.device)
            self.executor = Executor(self.holder, device=self.device)
            self.executor.coalescer = self.coalescer
            self.api = API(self.holder, self.executor)
            self.handler = Handler(self.api, self.host, self.port)
        except BaseException:
            if self.holder is not None:
                self.holder.close()
                self.holder = None
            self._release_containers()
            raise
        self.handler.serve_background()
        return self

    def close(self) -> None:
        if self.handler is not None:
            self.handler.close()
            self.handler = None
        if self.holder is not None:
            self.holder.close()
            self.holder = None
        self._release_containers()

    def _release_containers(self) -> None:
        if self._containers_retained:
            self._containers_retained = False
            containers.release()
