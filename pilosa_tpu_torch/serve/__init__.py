"""Serving-path protection: admission control and deadline propagation.

Copy of pilosa_tpu/serve/__init__.py.  The gate between the HTTP surface
(server/handler.py) and the device launches (parallel/executor.py,
parallel/coalescer.py): per-class concurrency caps with bounded wait
queues (admission.py) and end-to-end request deadlines (deadline.py), so
that overload degrades to 429/503 with ``Retry-After`` instead of
unbounded queueing, and expired work is dropped before any kernel
launch.
"""

from pilosa_tpu_torch.serve.admission import (  # noqa: F401
    CLASSES,
    AdmissionController,
    ShedError,
    rpc_class,
)
from pilosa_tpu_torch.serve.deadline import (  # noqa: F401
    Deadline,
    DeadlineExceededError,
)
