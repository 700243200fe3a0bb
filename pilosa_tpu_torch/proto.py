"""Proto3 wire codec for the node wire format.

A copy of pilosa_tpu/proto.py.

The reference speaks gogo-protobuf on its query and import endpoints
(negotiated via ``Content-Type: application/x-protobuf``,
http/handler.go:1002) and for all node-to-node RPC (http/client.go).
This module implements the proto3 WIRE FORMAT directly — varints,
length-delimited fields, packed repeated scalars — against hand-written
schema tables whose field numbers mirror ``internal/public.proto``
(the numbers ARE the compatibility surface, like the roaring 12348
cookie), so byte streams interoperate with the reference's messages
without a generated-code dependency.

Schema table format: {field_number: (name, kind[, sub_schema])} with
kinds: ``uint``/``int``/``bool`` (varint; ``int`` carries negatives via
64-bit two's complement like proto3 int64), ``string``/``bytes``
(length-delimited), ``double`` (fixed 64-bit), ``msg`` (nested), and
``*``-suffixed repeated forms (scalars encode packed, decode accepts
packed or unpacked — proto3 rules).

Result type codes and attr type codes mirror
encoding/proto/proto.go:1057-1067 and attr.go:27-30.
"""

from __future__ import annotations

import struct

_U64 = (1 << 64) - 1

# ---------------------------------------------------------------- wire core


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift >= 70:
            # 10 bytes max, like the vectorized packed decoder — an
            # 11th byte must reject identically on both paths (message
            # size must never decide accept vs reject)
            raise ValueError("varint too long")


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


#: byte-loop <-> numpy crossover for packed repeated fields; below this
#: the ndarray setup costs more than it saves
_NP_PACKED_MIN = 1024


def _encode_packed_np(vals, signed: bool) -> bytes:
    """Packed-varint encode of a large int sequence, fully vectorized
    (the byte-at-a-time loop costs ~1 us/value; bulk imports carry
    millions).  Bit-identical to ``_varint`` over canonical values."""
    import numpy as np

    if signed:
        v = np.asarray(vals, dtype=np.int64).astype(np.uint64)
    else:
        v = np.asarray(vals, dtype=np.uint64)
    nb = np.ones(len(v), dtype=np.int64)
    x = v >> np.uint64(7)
    while x.any():  # <= 9 iterations (10-byte varints max)
        nb += (x != 0)
        x >>= np.uint64(7)
    ends = np.cumsum(nb)
    total = int(ends[-1])
    starts = ends - nb
    k = (np.arange(total, dtype=np.uint64)
         - np.repeat(starts, nb).astype(np.uint64))
    vrep = np.repeat(v, nb)
    out = ((vrep >> (np.uint64(7) * k)) & np.uint64(0x7F)).astype(np.uint8)
    is_last = np.zeros(total, dtype=bool)
    is_last[ends - 1] = True
    out[~is_last] |= 0x80
    return out.tobytes()


def _decode_packed_np(raw: bytes, signed: bool, arrays: bool = False):
    """Packed-varint decode of a large buffer, fully vectorized.
    Semantics match the byte loop with the 64-bit mask the wire
    implies (contributions land in disjoint 7-bit lanes, so the
    add-reduce below IS the bitwise OR of the loop)."""
    import numpy as np

    a = np.frombuffer(raw, dtype=np.uint8)
    cont = (a & 0x80) != 0
    ends = np.flatnonzero(~cont)
    if len(ends) == 0 or ends[-1] != len(a) - 1:
        raise ValueError("truncated varint")
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    if int(lens.max()) > 10:
        raise ValueError("varint too long")
    k = (np.arange(len(a), dtype=np.uint64)
         - np.repeat(starts, lens).astype(np.uint64))
    contrib = (a & 0x7F).astype(np.uint64) << (np.uint64(7) * k)
    vals = np.add.reduceat(contrib, starts)
    if signed:
        vals = vals.astype(np.int64)
    return vals if arrays else vals.tolist()


def _signed(n: int) -> int:
    """Decode a 64-bit varint as proto3 int64."""
    n &= _U64
    return n - (1 << 64) if n > (1 << 63) - 1 else n


# ------------------------------------------------------------ encode/decode


def encode(schema: dict, obj: dict) -> bytes:
    """Encode a plain dict against a schema table.  proto3 semantics:
    zero/empty/None values are not emitted."""
    out = bytearray()
    for field in sorted(schema):
        spec = schema[field]
        name, kind = spec[0], spec[1]
        v = obj.get(name)
        # proto3 default: omit zero/empty/False.  Sized values (lists,
        # strings, ndarrays — whose truthiness raises) check len().
        if v is None:
            continue
        if hasattr(v, "__len__"):
            if len(v) == 0:
                continue
        elif not v and v != 0.0:
            continue
        if kind == "uint" or kind == "bool":
            if int(v) == 0:
                continue
            out += _key(field, 0) + _varint(int(v))
        elif kind == "int":
            if int(v) == 0:
                continue
            out += _key(field, 0) + _varint(int(v) & _U64)
        elif kind == "double":
            if float(v) == 0.0:
                continue
            out += _key(field, 1) + struct.pack("<d", float(v))
        elif kind == "string":
            b = v.encode()
            out += _key(field, 2) + _varint(len(b)) + b
        elif kind == "bytes":
            out += _key(field, 2) + _varint(len(v)) + bytes(v)
        elif kind == "msg":
            b = encode(spec[2], v)
            out += _key(field, 2) + _varint(len(b)) + b
        elif kind == "uint*" or kind == "int*":
            if len(v) >= _NP_PACKED_MIN:
                try:
                    packed = _encode_packed_np(v, signed=(kind == "int*"))
                except OverflowError:
                    # a value outside [-(2^63), 2^64) — the loop's
                    # explicit mask handles it
                    packed = b"".join(_varint(int(x) & _U64) for x in v)
            else:
                packed = b"".join(_varint(int(x) & _U64) for x in v)
            out += _key(field, 2) + _varint(len(packed)) + packed
        elif kind == "string*":
            for s in v:
                b = s.encode()
                out += _key(field, 2) + _varint(len(b)) + b
        elif kind == "msg*":
            for m in v:
                b = encode(spec[2], m)
                out += _key(field, 2) + _varint(len(b)) + b
        else:  # pragma: no cover - schema author error
            raise ValueError(f"unknown kind {kind!r}")
    return bytes(out)


def _default(kind: str):
    if kind.endswith("*"):
        return []
    return {"uint": 0, "int": 0, "bool": False, "double": 0.0,
            "string": "", "bytes": b"", "msg": None}[kind]


def decode(schema: dict, data: bytes, arrays: bool = False) -> dict:
    """Decode bytes against a schema table; unknown fields are skipped
    (proto3 forward compatibility), absent fields read as defaults.

    ``arrays=True`` leaves LARGE packed uint*/int* fields as numpy
    int64/uint64 ndarrays instead of Python lists — the bulk-import
    endpoints opt in so 2M-element ID arrays flow to
    field.import_bits' vectorized grouping with zero list
    materialization.  Callers opting in must length-check with
    ``len(x)`` (ndarray truthiness raises)."""
    obj = {spec[0]: _default(spec[1]) for spec in schema.values()}
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        spec = schema.get(field)
        if wire == 0:
            n, i = _read_varint(data, i)
            if spec is None:
                continue
            name, kind = spec[0], spec[1]
            if kind == "bool":
                obj[name] = bool(n)
            elif kind == "int":
                obj[name] = _signed(n)
            elif kind == "int*" or kind == "uint*":
                # unpacked repeated occurrence; legal proto3 encoders
                # may mix it with packed chunks, so an ndarray from an
                # earlier arrays=True chunk converts back to plain ints
                if not isinstance(obj[name], list):
                    obj[name] = obj[name].tolist()
                obj[name].append(_signed(n) if kind == "int*" else n & _U64)
            elif kind == "uint":
                obj[name] = n & _U64
            else:
                raise ValueError(
                    f"field {field} wire type 0 does not match {kind!r}")
        elif wire == 1:
            if i + 8 > len(data):
                raise ValueError("truncated fixed64")
            raw = data[i:i + 8]
            i += 8
            if spec is not None:
                obj[spec[0]] = struct.unpack("<d", raw)[0]
        elif wire == 2:
            ln, i = _read_varint(data, i)
            if i + ln > len(data):
                raise ValueError("truncated length-delimited field")
            raw = data[i:i + ln]
            i += ln
            if spec is None:
                continue
            name, kind = spec[0], spec[1]
            if kind == "string":
                obj[name] = raw.decode()
            elif kind == "bytes":
                obj[name] = raw
            elif kind == "msg":
                obj[name] = decode(spec[2], raw)
            elif kind == "string*":
                obj[name].append(raw.decode())
            elif kind == "msg*":
                obj[name].append(decode(spec[2], raw))
            elif kind == "uint*" or kind == "int*":
                if ln >= _NP_PACKED_MIN:
                    decoded = _decode_packed_np(
                        raw, signed=(kind == "int*"), arrays=arrays)
                    if arrays and isinstance(obj[name], list) \
                            and not obj[name]:
                        obj[name] = decoded
                    else:
                        # second occurrence (packed fields may be
                        # split): degrade to a plain-int list —
                        # .tolist(), never list(ndarray), so no np
                        # scalars leak into JSON-bound payloads
                        if not isinstance(obj[name], list):
                            obj[name] = obj[name].tolist()
                        obj[name].extend(
                            decoded.tolist() if arrays else decoded)
                else:
                    if not isinstance(obj[name], list):
                        obj[name] = obj[name].tolist()
                    j = 0
                    while j < ln:
                        n, j = _read_varint(raw, j)
                        # mask like the vectorized path (proto3 64-bit
                        # wire semantics) so both sizes decode alike
                        obj[name].append(
                            _signed(n) if kind == "int*" else n & _U64)
            else:
                raise ValueError(
                    f"field {field} wire type 2 does not match {kind!r}")
        elif wire == 5:
            if i + 4 > len(data):
                raise ValueError("truncated fixed32")
            i += 4  # no fixed32 fields in this schema set; skip
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return obj


# ------------------------------------------------- schemas (public.proto)

ATTR = {
    1: ("key", "string"),
    2: ("type", "uint"),
    3: ("stringValue", "string"),
    4: ("intValue", "int"),
    5: ("boolValue", "bool"),
    6: ("floatValue", "double"),
}

ROW = {
    1: ("columns", "uint*"),
    2: ("attrs", "msg*", ATTR),
    3: ("keys", "string*"),
}

ROW_IDENTIFIERS = {
    1: ("rows", "uint*"),
    2: ("keys", "string*"),
}

PAIR = {
    1: ("id", "uint"),
    2: ("count", "uint"),
    3: ("key", "string"),
}

FIELD_ROW = {
    1: ("field", "string"),
    2: ("rowID", "uint"),
    3: ("rowKey", "string"),
}

GROUP_COUNT = {
    1: ("group", "msg*", FIELD_ROW),
    2: ("count", "uint"),
}

VAL_COUNT = {
    1: ("val", "int"),
    2: ("count", "int"),
}

COLUMN_ATTR_SET = {
    1: ("id", "uint"),
    2: ("attrs", "msg*", ATTR),
    3: ("key", "string"),
}

QUERY_REQUEST = {
    1: ("query", "string"),
    2: ("shards", "uint*"),
    3: ("columnAttrs", "bool"),
    5: ("remote", "bool"),
    6: ("excludeRowAttrs", "bool"),
    7: ("excludeColumns", "bool"),
}

QUERY_RESULT = {
    1: ("row", "msg", ROW),
    2: ("n", "uint"),
    3: ("pairs", "msg*", PAIR),
    4: ("changed", "bool"),
    5: ("valCount", "msg", VAL_COUNT),
    6: ("type", "uint"),
    7: ("rowIDs", "uint*"),
    8: ("groupCounts", "msg*", GROUP_COUNT),
    9: ("rowIdentifiers", "msg", ROW_IDENTIFIERS),
}

QUERY_RESPONSE = {
    1: ("err", "string"),
    2: ("results", "msg*", QUERY_RESULT),
    3: ("columnAttrSets", "msg*", COLUMN_ATTR_SET),
}

IMPORT_REQUEST = {
    1: ("index", "string"),
    2: ("field", "string"),
    3: ("shard", "uint"),
    4: ("rowIDs", "uint*"),
    5: ("columnIDs", "uint*"),
    6: ("timestamps", "int*"),
    7: ("rowKeys", "string*"),
    8: ("columnKeys", "string*"),
}

IMPORT_VALUE_REQUEST = {
    1: ("index", "string"),
    2: ("field", "string"),
    3: ("shard", "uint"),
    5: ("columnIDs", "uint*"),
    6: ("values", "int*"),
    7: ("columnKeys", "string*"),
}

IMPORT_ROARING_VIEW = {
    1: ("name", "string"),
    2: ("data", "bytes"),
}

IMPORT_ROARING_REQUEST = {
    1: ("clear", "bool"),
    2: ("views", "msg*", IMPORT_ROARING_VIEW),
}

IMPORT_RESPONSE = {  # internal/private.proto ImportResponse
    1: ("err", "string"),
}

TRANSLATE_KEYS_REQUEST = {
    1: ("index", "string"),
    2: ("field", "string"),
    3: ("keys", "string*"),
}

TRANSLATE_KEYS_RESPONSE = {
    3: ("ids", "uint*"),
}

# result type codes (encoding/proto/proto.go:1057-1067)
TYPE_NIL = 0
TYPE_ROW = 1
TYPE_PAIRS = 2
TYPE_VAL_COUNT = 3
TYPE_UINT64 = 4
TYPE_BOOL = 5
TYPE_ROW_IDS = 6
TYPE_GROUP_COUNTS = 7
TYPE_ROW_IDENTIFIERS = 8
TYPE_PAIR = 9

# attr type codes (attr.go:27-30)
ATTR_STRING = 1
ATTR_INT = 2
ATTR_BOOL = 3
ATTR_FLOAT = 4


def attrs_to_proto(attrs: dict) -> list[dict]:
    out = []
    for k in sorted(attrs):
        v = attrs[k]
        if isinstance(v, bool):
            out.append({"key": k, "type": ATTR_BOOL, "boolValue": v})
        elif isinstance(v, int):
            out.append({"key": k, "type": ATTR_INT, "intValue": v})
        elif isinstance(v, float):
            out.append({"key": k, "type": ATTR_FLOAT, "floatValue": v})
        else:
            out.append({"key": k, "type": ATTR_STRING,
                        "stringValue": str(v)})
    return out


def proto_to_attrs(pb_attrs: list[dict]) -> dict:
    out = {}
    for a in pb_attrs:
        t = a["type"]
        if t == ATTR_BOOL:
            out[a["key"]] = a["boolValue"]
        elif t == ATTR_INT:
            out[a["key"]] = a["intValue"]
        elif t == ATTR_FLOAT:
            out[a["key"]] = a["floatValue"]
        else:
            out[a["key"]] = a["stringValue"]
    return out


# ----------------------------------------- result object <-> QueryResult


def result_to_proto(res) -> dict:
    """Executor result object -> QueryResult dict (the tagging logic of
    encoding/proto/proto.go:417-447)."""
    from pilosa_tpu_torch.models.row import Row
    from pilosa_tpu_torch.parallel.results import (
        GroupCount, Pair, PairField, ValCount,
    )

    if res is None:
        return {"type": TYPE_NIL}
    if isinstance(res, Row):
        row = {"attrs": attrs_to_proto(res.attrs or {})}
        if res.exclude_columns:
            pass
        elif res.keys:
            row["keys"] = list(res.keys)
        else:
            row["columns"] = [int(c) for c in res.columns()]
        return {"type": TYPE_ROW, "row": row}
    if isinstance(res, bool):
        return {"type": TYPE_BOOL, "changed": res}
    if isinstance(res, int):
        return {"type": TYPE_UINT64, "n": res}
    if isinstance(res, ValCount):
        return {"type": TYPE_VAL_COUNT,
                "valCount": {"val": int(res.val), "count": int(res.count)}}
    if isinstance(res, PairField):
        res = res.pair
    if isinstance(res, Pair):
        return {"type": TYPE_PAIR,
                "pairs": [_pair_to_proto(res)]}
    if isinstance(res, list):
        if res and isinstance(res[0], GroupCount):
            return {"type": TYPE_GROUP_COUNTS,
                    "groupCounts": [_group_count_to_proto(g) for g in res]}
        if res and isinstance(res[0], int):
            return {"type": TYPE_ROW_IDENTIFIERS,
                    "rowIdentifiers": {"rows": [int(r) for r in res]}}
        if res and isinstance(res[0], str):
            return {"type": TYPE_ROW_IDENTIFIERS,
                    "rowIdentifiers": {"keys": list(res)}}
        # TopN pair lists, including empty lists of any list kind
        pairs = []
        for p in res:
            if isinstance(p, PairField):
                p = p.pair
            pairs.append(_pair_to_proto(p))
        return {"type": TYPE_PAIRS, "pairs": pairs}
    raise TypeError(f"unserializable result type: {type(res)!r}")


def _pair_to_proto(p) -> dict:
    return {"id": int(p.id), "key": p.key or "", "count": int(p.count)}


def _group_count_to_proto(g) -> dict:
    return {
        "group": [
            {"field": fr.field, "rowID": int(fr.row_id),
             "rowKey": fr.row_key or ""}
            for fr in g.group
        ],
        "count": int(g.count),
    }


def proto_to_result(r: dict):
    """QueryResult dict -> the same objects the JSON path's
    deserialize_result produces, so remote protobuf partials feed the
    identical reduce paths."""
    from pilosa_tpu_torch.models.row import Row
    from pilosa_tpu_torch.parallel.results import (
        FieldRow, GroupCount, Pair, ValCount,
    )

    t = r["type"]
    if t == TYPE_NIL:
        return None
    if t == TYPE_ROW:
        pb = r["row"] or {}
        row = Row.from_columns(pb.get("columns") or [])
        row.keys = list(pb.get("keys") or [])
        row.attrs = proto_to_attrs(pb.get("attrs") or [])
        return row
    if t == TYPE_BOOL:
        return r["changed"]
    if t == TYPE_UINT64:
        return r["n"]
    if t == TYPE_VAL_COUNT:
        vc = r["valCount"] or {}
        return ValCount(val=vc.get("val", 0), count=vc.get("count", 0))
    if t == TYPE_PAIR:
        pairs = r["pairs"]
        p = pairs[0] if pairs else {"id": 0, "key": "", "count": 0}
        return Pair(id=p["id"], key=p["key"], count=p["count"])
    if t == TYPE_PAIRS:
        return [Pair(id=p["id"], key=p["key"], count=p["count"])
                for p in r["pairs"]]
    if t == TYPE_GROUP_COUNTS:
        return [
            GroupCount(
                group=[FieldRow(field=fr["field"], row_id=fr["rowID"],
                                row_key=fr["rowKey"])
                       for fr in g["group"]],
                count=g["count"],
            )
            for g in r["groupCounts"]
        ]
    if t == TYPE_ROW_IDENTIFIERS:
        ri = r["rowIdentifiers"] or {}
        return list(ri.get("keys") or []) or [int(x)
                                              for x in ri.get("rows") or []]
    if t == TYPE_ROW_IDS:
        return [int(x) for x in r["rowIDs"]]
    raise ValueError(f"unknown result type code {t}")
