"""API facade: the actions the HTTP handler exposes, on one node.

Port of the single-node part of pilosa_tpu/api.py: query, index and
field creation, bit import and roaring import.  The cluster state
machine, key translation and replica fan-out are not part of the port
yet; the node is always NORMAL.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.models.field import FieldOptions, FieldType
from pilosa_tpu_torch.models.index import IndexOptions
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.parallel.executor import ExecOptions


class ApiError(Exception):
    """Base API error; the HTTP layer maps subclasses to status codes."""


class NotFoundError(ApiError):
    pass


class ConflictError(ApiError):
    pass


class API:
    def __init__(self, holder, executor):
        self.holder = holder
        self.executor = executor

    def query(self, index: str, pql, shards=None,
              exclude_columns: bool = False, containers: bool = True,
              coalesce: bool = True, vm: bool = True) -> list:
        opt = ExecOptions(exclude_columns=exclude_columns,
                          shards=None if shards is None else list(shards),
                          coalesce=coalesce, containers=containers, vm=vm)
        return self.executor.execute(index, pql, opt=opt)

    def index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise NotFoundError(f"index not found: {name}")
        return idx

    def create_index(self, name: str, options: IndexOptions | None = None):
        if self.holder.index(name) is not None:
            raise ConflictError(f"index already exists: {name}")
        if options is not None and options.keys:
            raise ApiError("string keys are not supported by this port yet")
        return self.holder.create_index(name, options)

    def field(self, index: str, name: str):
        f = self.index(index).field(name)
        if f is None:
            raise NotFoundError(f"field not found: {name}")
        return f

    def create_field(self, index: str, name: str,
                     options: FieldOptions | None = None):
        idx = self.index(index)
        if idx.field(name) is not None:
            raise ConflictError(f"field already exists: {name}")
        options = options or FieldOptions()
        if options.type != FieldType.SET or options.keys:
            raise ApiError(f"only set fields without keys are supported by "
                           f"this port yet, not {options.type!r}"
                           + (" with keys" if options.keys else ""))
        return idx.create_field(name, options)

    def import_bits(self, index: str, field: str, rows, cols,
                    row_keys=None, col_keys=None, clear: bool = False) -> None:
        """Bulk bit import; imported columns join the existence field
        (pilosa_tpu/api.py:269)."""
        if row_keys or col_keys:
            raise ApiError("string keys are not supported by this port yet")
        idx = self.index(index)
        f = self.field(index, field)
        rows = np.asarray(rows if len(rows) else [], dtype=np.int64)
        cols = np.asarray(cols if len(cols) else [], dtype=np.int64)
        f.import_bits(rows, cols, clear=clear)
        if not clear:
            idx.import_existence(cols)

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool = False) -> None:
        """Merge serialized roaring bitmaps into one shard's standard
        view (pilosa_tpu/api.py:470).  The existence field is left as it
        is, as in the reference."""
        f = self.field(index, field)
        if f.options.type != FieldType.SET:
            raise ApiError("roaring import is only supported for set fields "
                           "by this port")
        for vname in views:
            if vname not in ("", VIEW_STANDARD):
                raise ApiError(f"view {vname!r} is not supported by this "
                               f"port yet")
        for data in views.values():
            f.import_roaring(shard, data, clear=clear)

    def state(self) -> str:
        return "NORMAL"
