"""Index: a namespace of fields sharing one column space.

Port of pilosa_tpu/models/index.py: the ``.meta`` options file in the
reference's format, field creation and deletion, and, with ``track_existence`` (the default), the
hidden ``_exists`` field recording which columns hold any data -- the
universe ``Not()`` complements within.  With ``keys`` the index
translates string column keys through a translate store opened lazily
in ``.keys.db`` (pilosa_tpu/models/index.py:52-68); column attributes
live in ``.column_attrs.db``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.models.attrs import AttrStore
from pilosa_tpu_torch.models.field import (
    Field,
    FieldOptions,
    atomic_write_json,
    validate_name,
)

EXISTENCE_FIELD = "_exists"


@dataclass
class IndexOptions:
    keys: bool = False
    track_existence: bool = True

    def to_dict(self) -> dict:
        return {"keys": self.keys, "trackExistence": self.track_existence}

    @classmethod
    def from_dict(cls, d: dict) -> "IndexOptions":
        return cls(keys=d.get("keys", False),
                   track_existence=d.get("trackExistence", True))


class Index:
    def __init__(self, path: str | None, name: str, device: torch.device,
                 options: IndexOptions | None = None):
        validate_name(name)
        self.path = path
        self.name = name
        self.device = device
        self.options = options or IndexOptions()
        self.fields: dict[str, Field] = {}
        self._lock = threading.RLock()
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._load_meta()
            self._open_fields()
        if self.options.track_existence and EXISTENCE_FIELD not in self.fields:
            self._create_field(EXISTENCE_FIELD,
                               FieldOptions(cache_type="none"))
        self.column_attrs = AttrStore(
            None if path is None else os.path.join(path, ".column_attrs.db"))
        self._translate_store = None

    @property
    def translate_store(self):
        """The column-key translate store, opened at first use."""
        if self._translate_store is None:
            from pilosa_tpu_torch.storage.translate import \
                open_translate_store

            self._translate_store = open_translate_store(
                None if self.path is None
                else os.path.join(self.path, ".keys.db"))
        return self._translate_store

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def _load_meta(self) -> None:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.options = IndexOptions.from_dict(json.load(f))
        else:
            atomic_write_json(self._meta_path, self.options.to_dict())

    def _open_fields(self) -> None:
        for name in sorted(os.listdir(self.path)):
            fdir = os.path.join(self.path, name)
            if (os.path.isdir(fdir)
                    and os.path.exists(os.path.join(fdir, ".meta"))):
                self.fields[name] = self._adopt(Field(
                    fdir, self.name, name, FieldOptions(), self.device))

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def existence_field(self) -> Field | None:
        if not self.options.track_existence:
            return None
        return self.fields.get(EXISTENCE_FIELD)

    def create_field(self, name: str,
                     options: FieldOptions | None = None) -> Field:
        with self._lock:
            if name in self.fields:
                raise ValueError(f"field already exists: {name}")
            return self._create_field(name, options or FieldOptions())

    def create_field_if_not_exists(self, name: str,
                                   options: FieldOptions | None = None
                                   ) -> Field:
        with self._lock:
            f = self.fields.get(name)
            if f is not None:
                return f
            return self._create_field(name, options or FieldOptions())

    def delete_field(self, name: str) -> None:
        """Close the field, release what it holds on the card and the
        host, and remove its directory (pilosa_tpu/models/index.py:139)."""
        with self._lock:
            f = self.fields.pop(name, None)
            if f is None:
                raise KeyError(f"field not found: {name}")
            f.close()
            if f.path is not None:
                shutil.rmtree(f.path, ignore_errors=True)

    def _create_field(self, name: str, options: FieldOptions) -> Field:
        validate_name(name)
        path = None if self.path is None else os.path.join(self.path, name)
        f = self._adopt(Field(path, self.name, name, options, self.device))
        self.fields[name] = f
        return f

    def _adopt(self, f: Field) -> Field:
        """Give the field a weak back-reference to its index: the prewarm
        worker needs the index's shard set, which the fused executor keys
        stacks by (pilosa_tpu/models/index.py:101-109)."""
        f._index_ref = weakref.ref(self)
        return f

    def all_fields(self) -> list[Field]:
        """Public and internal fields (``_exists``), by name
        (pilosa_tpu/models/index.py:168)."""
        return [f for _, f in sorted(self.fields.items())]

    def public_fields(self) -> list[Field]:
        return [f for n, f in sorted(self.fields.items())
                if not n.startswith("_")]

    def import_existence(self, cols) -> None:
        """Record imported columns in the existence field."""
        f = self.existence_field()
        if f is not None and len(cols):
            f.import_bits(np.zeros(len(cols), dtype=np.int64), cols)

    def available_shards(self) -> set[int]:
        """Union of the per-field shard sets."""
        shards: set[int] = set()
        for f in self.fields.values():
            shards |= f.available_shards()
        return shards

    def close(self) -> None:
        for f in self.fields.values():
            f.close()
        self.column_attrs.close()
        if self._translate_store is not None:
            self._translate_store.close()

    def snapshot(self) -> None:
        for f in self.fields.values():
            f.snapshot()
