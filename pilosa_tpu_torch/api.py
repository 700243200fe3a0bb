"""API facade: the actions the HTTP handler exposes, on one node.

Port of the single-node part of pilosa_tpu/api.py: query, index and
field creation (set and int fields, and, as in the reference, fields of
a type string it does not know, served as set fields), bit import,
value import and roaring import into set fields.  The cluster state
machine, key translation and replica fan-out are not part of the port
yet; the node is always NORMAL.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.models.field import (UNSERVED_TYPES, FieldOptions,
                                           FieldType)
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
              coalesce: bool = True, vm: bool = True,
              delta: bool = True, cache: bool = True) -> list:
        opt = ExecOptions(exclude_columns=exclude_columns,
                          shards=None if shards is None else list(shards),
                          coalesce=coalesce, containers=containers, vm=vm,
                          delta=delta, cache=cache)
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
        # a type string the reference does not know is stored as given
        # and served as a set field, as the reference does
        if options.type in UNSERVED_TYPES:
            raise ApiError(f"{options.type} fields are not supported by "
                           f"this port yet")
        if options.keys:
            raise ApiError("fields with keys are not supported by this port "
                           "yet")
        return idx.create_field(name, options)

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None, row_keys=None, col_keys=None,
                    clear: bool = False) -> None:
        """Bulk bit import; imported columns join the existence field
        (pilosa_tpu/api.py:269)."""
        if row_keys or col_keys:
            raise ApiError("string keys are not supported by this port yet")
        idx = self.index(index)
        f = self.field(index, field)
        rows = np.asarray(rows if len(rows) else [], dtype=np.int64)
        cols = np.asarray(cols if len(cols) else [], dtype=np.int64)
        f.import_bits(rows, cols, timestamps, clear=clear)
        if not clear:
            idx.import_existence(cols)

    def import_values(self, index: str, field: str, cols, values,
                      col_keys=None) -> None:
        """Bulk BSI value import; imported columns join the existence
        field (pilosa_tpu/api.py:339)."""
        if col_keys:
            raise ApiError("string keys are not supported by this port yet")
        idx = self.index(index)
        f = self.field(index, field)
        cols, values = list(cols), list(values)
        f.import_values(cols, values)
        idx.import_existence(cols)

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool = False) -> None:
        """Merge serialized roaring bitmaps into one shard's fragments
        (pilosa_tpu/api.py:470): a set field's standard view (named
        ``""`` or ``"standard"``), or a time field's.  Like the reference,
        every other field type is refused, and the existence field is
        left as it is.  An int field's planes load in process through
        ``Field.import_roaring`` with ``view="bsig_<field>"``."""
        f = self.field(index, field)
        if f.options.type not in (FieldType.SET, FieldType.TIME):
            raise ApiError("roaring import is only supported for set "
                           "and time fields")
        for vname in views:
            if vname not in ("", VIEW_STANDARD):
                raise ApiError(f"view {vname!r} of field {field!r} is not "
                               f"supported by this port yet")
        for vname, data in views.items():
            f.import_roaring(shard, data, clear=clear, view=VIEW_STANDARD)

    def state(self) -> str:
        return "NORMAL"
