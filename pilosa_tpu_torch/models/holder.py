"""Holder: all data on one node -- a directory of indexes.

Port of pilosa_tpu/models/holder.py: opens every index directory under
the data path, holds an exclusive flock on the directory for its
lifetime, keeps the node id in ``.id``, and describes the schema.  The
holder's device (``cuda`` unless the caller asks for ``cpu``) is where
every field places its row stacks and container pools.  Opening a
directory queues a background prewarm of every field's stacks
(runtime/prewarm.py); ``close`` drops the holder's queued prewarm jobs
and waits out a running one first.
"""

from __future__ import annotations

import fcntl
import itertools
import os
import shutil
import threading
import uuid

import torch

from pilosa_tpu_torch import device as devmod
from pilosa_tpu_torch.models.field import FieldOptions
from pilosa_tpu_torch.models.index import Index, IndexOptions
from pilosa_tpu_torch.runtime import prewarm
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class Holder:
    #: process-unique identity: result-cache keys carry it, so that two
    #: holders in one process never share entries
    #: (pilosa_tpu/models/holder.py:20-29)
    _UID = itertools.count(1)

    def __init__(self, path: str | None = None,
                 device: str | torch.device | None = None):
        self.device = devmod.resolve(device)
        self.uid = next(Holder._UID)
        self.path = path
        self.indexes: dict[str, Index] = {}
        self._lock = threading.RLock()
        self._lock_file = None
        if path is None:
            self.node_id = uuid.uuid4().hex
            return
        os.makedirs(path, exist_ok=True)
        self._acquire_dir_lock()
        try:
            self._load_node_id()
            for name in sorted(os.listdir(path)):
                idir = os.path.join(path, name)
                if (os.path.isdir(idir)
                        and os.path.exists(os.path.join(idir, ".meta"))):
                    self.indexes[name] = Index(idir, name, self.device)
            self._prewarm_all()
        except BaseException:
            self._release_dir_lock()
            raise

    def _prewarm_all(self) -> None:
        """Queue a background stack prewarm for every reopened field
        (pilosa_tpu/models/holder.py:144-154): a restarted server's first
        query finds its stacks on the card instead of paying the
        assembly."""
        for idx in self.indexes.values():
            for f in idx.fields.values():
                prewarm.enqueue(idx, f)

    def _acquire_dir_lock(self) -> None:
        """A second process opening the same directory fails fast."""
        self._lock_file = open(os.path.join(self.path, ".lock"), "w")
        try:
            fcntl.flock(self._lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            self._lock_file.close()
            self._lock_file = None
            raise RuntimeError(f"data directory {self.path!r} is locked by "
                               f"another process") from e

    def _release_dir_lock(self) -> None:
        if self._lock_file is not None:
            fcntl.flock(self._lock_file, fcntl.LOCK_UN)
            self._lock_file.close()
            self._lock_file = None

    def _load_node_id(self) -> None:
        idp = os.path.join(self.path, ".id")
        if os.path.exists(idp):
            with open(idp) as f:
                self.node_id = f.read().strip()
        else:
            self.node_id = uuid.uuid4().hex
            with open(idp, "w") as f:
                f.write(self.node_id)

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def create_index(self, name: str,
                     options: IndexOptions | None = None) -> Index:
        with self._lock:
            if name in self.indexes:
                raise ValueError(f"index already exists: {name}")
            return self._create_index(name, options)

    def create_index_if_not_exists(self, name: str,
                                   options: IndexOptions | None = None
                                   ) -> Index:
        with self._lock:
            idx = self.indexes.get(name)
            if idx is not None:
                return idx
            return self._create_index(name, options)

    def _create_index(self, name: str, options: IndexOptions | None
                      ) -> Index:
        path = None if self.path is None else os.path.join(self.path, name)
        idx = Index(path, name, self.device, options or IndexOptions())
        self.indexes[name] = idx
        return idx

    def delete_index(self, name: str) -> None:
        """Close the index, release its fields' device forms and remove
        its directory (pilosa_tpu/models/holder.py:116)."""
        with self._lock:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise KeyError(f"index not found: {name}")
            prewarm.cancel([idx])
            idx.close()
            if idx.path is not None:
                shutil.rmtree(idx.path, ignore_errors=True)

    def schema(self) -> list[dict]:
        """The JSON-able schema (reference Holder.Schema, holder.go:284;
        pilosa_tpu/models/holder.py:127)."""
        out = []
        for iname, idx in sorted(self.indexes.items()):
            out.append({
                "name": iname,
                "options": idx.options.to_dict(),
                "fields": [{"name": f.name, "options": f.options.to_dict()}
                           for f in idx.public_fields()],
                "shardWidth": SHARD_WIDTH,
            })
        return out

    def apply_schema(self, schema: list[dict]) -> None:
        """Create the indexes and fields of a schema description that do
        not exist yet (reference applySchema, holder.go:327)."""
        for idesc in schema:
            idx = self.create_index_if_not_exists(
                idesc["name"], IndexOptions.from_dict(idesc.get("options", {})))
            for fdesc in idesc.get("fields", []):
                idx.create_field_if_not_exists(
                    fdesc["name"],
                    FieldOptions.from_dict(fdesc.get("options", {})))

    def close(self) -> None:
        """Drop this holder's queued prewarm jobs and wait out a running
        one, then close every index and release the directory lock."""
        try:
            prewarm.cancel(list(self.indexes.values()))
            for idx in self.indexes.values():
                idx.close()
        finally:
            self._release_dir_lock()

    def snapshot(self) -> None:
        for idx in self.indexes.values():
            idx.snapshot()
