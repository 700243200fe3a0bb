"""End-to-end request deadlines for the serving path.

Copy of pilosa_tpu/serve/deadline.py.  A deadline is a remaining budget
carried on the wire as the ``X-Pilosa-Deadline`` header (float seconds),
relative rather than absolute so that it survives clock skew: each hop
derives its own monotonic expiry from the budget at receive time.

The handler parses the header into a :class:`Deadline` and installs it
for the request (:class:`scope`); the API checks it before the query
runs, the executor carries it in ``ExecOptions`` and checks it at the
translate, map, per-shard and reduce boundaries, and the coalescer drops
expired batch entries before their launch.  Expiry raises
:class:`DeadlineExceededError`, which the HTTP layer answers with 503.
"""

from __future__ import annotations

import math
import threading
import time

#: Wire header carrying the remaining budget in seconds (float).
HEADER = "X-Pilosa-Deadline"

#: Budgets above this clamp down: a 25-hour deadline is a typo, and an
#: unbounded one would defeat the queue-wait arithmetic of admission.
MAX_BUDGET_S = 86400.0

_tls = threading.local()  # .dl: the Deadline active on this thread


class DeadlineExceededError(Exception):
    """The request's deadline expired before (or during) execution.
    Deliberately not a ValueError: the HTTP layer answers it with 503,
    not the 400 of a client error."""


class Deadline:
    """A monotonic expiry derived from a remaining budget."""

    __slots__ = ("budget_s", "expires_mono")

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.expires_mono = time.monotonic() + budget_s

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_mono - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


def parse_header(value: str) -> Deadline:
    """``X-Pilosa-Deadline`` value -> Deadline.  A malformed or non-finite
    value raises ValueError (the handler answers 400).  Zero or a negative
    budget is valid and means already expired."""
    budget = float(value)
    if not math.isfinite(budget):
        raise ValueError(f"non-finite deadline: {value!r}")
    return Deadline(min(budget, MAX_BUDGET_S))


def current() -> Deadline | None:
    """The deadline active on this thread, or None."""
    return getattr(_tls, "dl", None)


class tls_scope:
    """Re-entrant save/set/restore of one attribute of a threading.local,
    the base of every per-request scope (``deadline.scope``,
    ``admission.rpc_class``, ``tenant.scope``).  ``__enter__`` returns the
    value installed; ``__exit__`` restores what was active before."""

    __slots__ = ("_tls_obj", "_attr", "value", "_prev")

    def __init__(self, tls_obj, attr: str, value):
        self._tls_obj = tls_obj
        self._attr = attr
        self.value = value

    def __enter__(self):
        self._prev = getattr(self._tls_obj, self._attr, None)
        setattr(self._tls_obj, self._attr, self.value)
        return self.value

    def __exit__(self, *exc):
        setattr(self._tls_obj, self._attr, self._prev)
        return False


class scope(tls_scope):
    """Install a deadline (or None) as this thread's active deadline for
    a with-block."""

    __slots__ = ()

    def __init__(self, dl: Deadline | None):
        super().__init__(_tls, "dl", dl)


def check(dl: Deadline | None, where: str) -> None:
    """Raise DeadlineExceededError when ``dl`` exists and has expired."""
    if dl is not None and dl.expired():
        raise DeadlineExceededError(f"deadline expired before {where}")
