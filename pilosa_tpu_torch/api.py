"""API facade: the actions the HTTP handler exposes, on one node.

Port of the single-node part of pilosa_tpu/api.py: query; the schema
(``schema``, ``apply_schema``) and index and field creation and deletion
for every field type the reference creates (set, int, time, mutex and
bool, and, as in the reference, a type string it does not know, served
as a set field); bit, value and roaring import; the CSV export; and the
node's admin answers (``hosts``, ``info``, ``version``,
``recalculate_caches``, ``shards_max``, ``shard_nodes``) for the one
local node, as the reference answers with its cluster off
(pilosa_tpu/api.py:221-262, 510-581).  ``max_writes_per_request`` (0, no
limit, unless the server sets it) refuses a query with more write calls,
with the reference's message (pilosa_tpu/api.py:78, 179-190).  String keys
translate through the local branch of the reference's
``node.translate_keys_cluster`` (pilosa_tpu/parallel/node.py:710):
existing keys resolve, new ones are created in the index's or field's
store.  The cluster state machine, its key routing and replica fan-out
are not part of the port yet; the node is always NORMAL.
"""

from __future__ import annotations

import io

import numpy as np

from pilosa_tpu_torch import VERSION
from pilosa_tpu_torch.models.field import FieldOptions, FieldType
from pilosa_tpu_torch.models.index import IndexOptions
from pilosa_tpu_torch.models.view import VIEW_BSI_PREFIX, VIEW_STANDARD
from pilosa_tpu_torch.parallel.executor import ExecOptions
from pilosa_tpu_torch.pql import Query, parse
from pilosa_tpu_torch.runtime import resultcache
from pilosa_tpu_torch.serve import deadline as _deadline
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


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
        # the node's address, set by the server once its handler listens
        self.uri = ""
        self.max_writes_per_request = 0  # 0 = unlimited

    def query(self, index: str, pql, shards=None,
              exclude_columns: bool = False, containers: bool = True,
              coalesce: bool = True, vm: bool = True,
              delta: bool = True, cache: bool = True,
              column_attrs: bool = False,
              exclude_row_attrs: bool = False,
              tenant: str | None = None, tiers: bool = True) -> list:
        """Execute PQL -> results.  The deadline is the one the handler
        installed on this thread (``serve.deadline.scope``): an expired
        one raises here, before translation touches anything
        (pilosa_tpu/api.py:119-126), and the executor checks it again at
        its stage boundaries.  ``tenant`` is the request's tenant id
        (``X-Pilosa-Tenant``), inert with [tenants] off; ``tiers=False``
        (``?notiers=1``) bypasses the residency manager's host tier."""
        dl = _deadline.current()
        _deadline.check(dl, "query execution")
        if self.max_writes_per_request > 0:
            # parsed once here; the executor takes the Query as it is
            q = (parse(pql, allow_internal=False) if isinstance(pql, str)
                 else pql)
            if isinstance(q, Query) and (
                    q.write_call_n() > self.max_writes_per_request):
                raise ApiError(
                    f"too many writes in one request "
                    f"({q.write_call_n()} > {self.max_writes_per_request})")
            pql = q
        opt = ExecOptions(exclude_columns=exclude_columns,
                          column_attrs=column_attrs,
                          exclude_row_attrs=exclude_row_attrs,
                          shards=None if shards is None else list(shards),
                          coalesce=coalesce, containers=containers, vm=vm,
                          delta=delta, cache=cache, deadline=dl,
                          tenant=tenant, tiers=tiers)
        return self.executor.execute(index, pql, opt=opt)

    # ------------------------------------------------------------- schema

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: list[dict]) -> None:
        """Idempotent schema merge (api.go ApplySchema): the indexes and
        fields that do not exist yet are created."""
        self.holder.apply_schema(schema)

    def index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise NotFoundError(f"index not found: {name}")
        return idx

    def create_index(self, name: str, options: IndexOptions | None = None):
        if self.holder.index(name) is not None:
            raise ConflictError(f"index already exists: {name}")
        return self.holder.create_index(name, options)

    def delete_index(self, name: str) -> None:
        """Delete an index, its files and every result-cache entry of it
        (the cached stacks and pools go with its fields)."""
        self.index(name)
        self.holder.delete_index(name)
        resultcache.cache().invalidate_index(self.holder.uid, name)

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
        return idx.create_field(name, options or FieldOptions())

    def delete_field(self, index: str, name: str) -> None:
        """Delete a field, its files, its device forms and every result-
        cache entry of its index."""
        self.field(index, name)
        self.index(index).delete_field(name)
        resultcache.cache().invalidate_index(self.holder.uid, index)

    # ------------------------------------------------------------- import

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None, row_keys=None, col_keys=None,
                    clear: bool = False) -> None:
        """Bulk bit import; imported columns join the existence field
        (pilosa_tpu/api.py:269).  Column keys translate in the index's
        store, row keys in the field's, each created when new."""
        idx = self.index(index)
        f = self.field(index, field)
        if col_keys:
            cols = self.translate_keys(index, None, col_keys, create=True)
        if row_keys:
            cols_n = len(cols)
            rows = self.translate_keys(index, field, row_keys, create=True)
            if len(rows) != cols_n:
                raise ApiError("row keys and columns length mismatch")
        rows = np.asarray(rows if len(rows) else [], dtype=np.int64)
        cols = np.asarray(cols if len(cols) else [], dtype=np.int64)
        f.import_bits(rows, cols, timestamps, clear=clear)
        if not clear:
            idx.import_existence(cols)

    def import_values(self, index: str, field: str, cols, values,
                      col_keys=None) -> None:
        """Bulk BSI value import; imported columns join the existence
        field (pilosa_tpu/api.py:339)."""
        idx = self.index(index)
        f = self.field(index, field)
        if col_keys:
            cols = self.translate_keys(index, None, col_keys, create=True)
        cols, values = list(cols), list(values)
        f.import_values(cols, values)
        idx.import_existence(cols)

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool = False) -> None:
        """Merge serialized roaring bitmaps, one per named view (``""`` is
        the standard view), into one shard's fragments of a set or time
        field (pilosa_tpu/api.py:470-499).  Every other field type is
        refused as the reference refuses it, and the existence field is
        left as it is.  An int field's planes load in process through
        ``Field.import_roaring`` with ``view="bsig_<field>"``."""
        f = self.field(index, field)
        if f.options.type not in (FieldType.SET, FieldType.TIME):
            raise ApiError("roaring import is only supported for set "
                           "and time fields")
        for vname, data in views.items():
            f.import_roaring(shard, data, clear=clear,
                             view=vname or VIEW_STANDARD)

    def translate_keys(self, index: str, field: str | None, keys,
                       create: bool = False) -> list:
        """Keys -> ids in the index's column store (``field`` None) or
        the field's row store, new keys created when ``create``: the
        local branch of the reference's ``node.translate_keys_cluster``
        (pilosa_tpu/parallel/node.py:710-740), the one node being the
        coordinator.  The store's batched call looks the keys up before
        it creates any, so one call does both."""
        idx = self.holder.index(index)
        store = None
        if idx is not None:
            if field:
                f = idx.field(field)
                store = None if f is None else f.translate_store
            else:
                store = idx.translate_store
        if store is None:
            raise ValueError(f"no translate store for {index}/{field}")
        return store.translate_keys(list(keys), create=create)

    # ------------------------------------------------------------- export

    def export_csv(self, index: str, field: str, shard: int,
                   w: io.TextIOBase) -> None:
        """``row,col`` lines of one shard's standard view, rows ascending
        and columns ascending within a row, each label the key where the
        field or index has keys and the key exists (api.go:500
        API.ExportCSV; pilosa_tpu/api.py:510)."""
        idx = self.index(index)
        f = self.field(index, field)
        frag = f.fragment(shard)
        if frag is None:
            return
        base = shard * SHARD_WIDTH
        for row_id in frag.row_ids():
            words = frag.row(row_id)
            cols = base + np.nonzero(np.unpackbits(
                words.view(np.uint8), bitorder="little"))[0]
            row_label = row_id
            if f.options.keys:
                row_label = f.translate_store.translate_id(row_id) or row_id
            col_labels = [int(c) for c in cols]
            if idx.options.keys:
                keys = idx.translate_store.translate_ids(col_labels)
                col_labels = [k or c for k, c in zip(keys, col_labels)]
            w.write("".join(f"{row_label},{c}\n" for c in col_labels))

    # -------------------------------------------------------------- admin

    def hosts(self) -> list[dict]:
        """The one local node, as the reference lists it with its cluster
        off."""
        return [{"id": self.holder.node_id, "uri": self.uri,
                 "isCoordinator": True, "state": "READY"}]

    def shards_max(self) -> dict[str, int]:
        """index -> its highest shard, for the indexes that hold any
        (pilosa_tpu/api.py:570-578)."""
        out = {}
        for d in self.holder.schema():
            shards = self.holder.index(d["name"]).available_shards()
            if shards:
                out[d["name"]] = max(shards)
        return out

    def shard_nodes(self, index: str, shard: int) -> list[dict]:
        """The nodes that own a shard: on one node, the node itself,
        whatever the index and shard (pilosa_tpu/api.py:580-581)."""
        return self.hosts()

    def recalculate_caches(self) -> None:
        """Recompute every fragment's TopN rank cache (reference
        API.RecalculateCaches, api.go:1139; BSI views have none)."""
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for vname, view in list(f.views.items()):
                    if vname.startswith(VIEW_BSI_PREFIX):
                        continue
                    for frag in list(view.fragments.values()):
                        frag.recalculate_cache()

    def info(self) -> dict:
        """The node's shape (pilosa_tpu/api.py:551), with ``cpuType``
        naming the device it serves on."""
        return {
            "shardWidth": SHARD_WIDTH,
            "memory": None,
            "cpuType": f"{self.holder.device.type}+host",
            "cpuPhysicalCores": None,
            "cpuLogicalCores": None,
        }

    def version(self) -> str:
        return VERSION

    def state(self) -> str:
        return "NORMAL"
