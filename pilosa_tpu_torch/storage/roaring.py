"""Roaring codec: Pilosa's 64-bit roaring file format (cookie 12348).

Copy of the numpy path of pilosa_tpu/storage/roaring.py (the native C++
codec is not part of the port yet): bit-compatible with the reference's
serialization, decoding both the pilosa format (12348) and the official
32-bit interchange formats (12346/12347).  Decoded form is (keys u64[n],
words u64[n, 1024]) -- dense 2^16-bit blocks keyed by position >> 16.
"""

from __future__ import annotations

import numpy as np

WORDS_PER_CONTAINER = 1024
CONTAINER_BITS = 1 << 16
MAGIC = 12348
COOKIE_OFFICIAL = 12346       # official roaring, no run containers
COOKIE_OFFICIAL_RUNS = 12347  # official roaring + run-flag bitset

#: Container kinds as the DEVICE directory numbers them (the kind byte
#: in ops/containers.ContainerLeaf; the wire format's type field uses
#: 1=array/2=bitmap/3=run instead — see ``_WIRE_TYPE``).
KIND_BITMAP = 1
KIND_ARRAY = 2
KIND_RUN = 3

#: The reference's array-container cardinality ceiling: above this a
#: sorted-uint16 array costs more than the 8 KiB bitmap.
ARRAY_MAX_CARD = 4096

#: Device kind -> serialized container type (roaring/roaring.go
#: containerArray/containerBitmap/containerRun).
_WIRE_TYPE = {KIND_ARRAY: 1, KIND_BITMAP: 2, KIND_RUN: 3}


def pick_kind(card: int, n_runs: int,
              array_max: int = ARRAY_MAX_CARD) -> int:
    """The roaring cost rule: cheapest of bitmap (8192 B), sorted
    uint16 array (2*card B, card <= array_max), interval-list run
    (2 + 4*n_runs B) — byte-for-byte the serializer's choice
    (roaring/roaring.go optimize()), shared by ``_encode_py`` and the
    device directory build so wire and device kinds can never drift.
    ``array_max`` only narrows the device pick (size-class packing
    caps); serialization always passes the canonical 4096."""
    array_size = 2 * card if card <= array_max else 1 << 62
    run_size = 2 + 4 * n_runs
    if run_size < array_size and run_size < 8192:
        return KIND_RUN
    if array_size <= 8192:
        return KIND_ARRAY
    return KIND_BITMAP


_ERRORS = {
    -1: "truncated roaring data",
    -2: "bad roaring magic (want 12348)",
    -3: "unsupported roaring file version",
    -4: "unknown container type",
    -5: "container offset out of bounds",
    -6: "serialized size exceeds the format's 4 GiB offset limit",
    -7: "decoded positions exceed the caller's cap",
}


class RoaringError(ValueError):
    pass


# --------------------------------------------------------------- decode


def decode(data: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse serialized roaring -> (keys u64[n], words u64[n,1024], flags).

    Accepts both the pilosa 64-bit format (cookie 12348) and the
    official 32-bit roaring interchange format (cookies 12346/12347),
    like the reference's UnmarshalBinary (roaring/unmarshal_binary.go
    handles both; the official-format golden file is
    roaring/testdata/bitmapcontainer.roaringbitmap)."""
    if len(data) >= 4:
        cookie16 = int.from_bytes(data[:2], "little")
        cookie32 = int.from_bytes(data[:4], "little")
        if cookie32 == COOKIE_OFFICIAL or cookie16 == COOKIE_OFFICIAL_RUNS:
            return _decode_official(data)
    return _decode_py(data)


def _decode_py(data: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) < 8:
        raise RoaringError("truncated roaring data")
    magic = int(buf[0]) | (int(buf[1]) << 8)
    if magic != MAGIC:
        raise RoaringError("bad roaring magic (want 12348)")
    if buf[2] != 0:
        raise RoaringError("unsupported roaring file version")
    flags = int(buf[3])
    n = int(np.frombuffer(data, dtype=np.uint32, count=1, offset=4)[0])
    if len(buf) < 8 + n * 16:
        raise RoaringError("truncated roaring data")
    # 12-byte descriptive entries, then a separate 4-byte offset section
    desc = np.frombuffer(data, dtype=np.uint8, count=n * 12, offset=8)
    keys = desc.reshape(n, 12)[:, :8].copy().view(np.uint64).reshape(n)
    typs = desc.reshape(n, 12)[:, 8:10].copy().view(np.uint16).reshape(n)
    cards = desc.reshape(n, 12)[:, 10:12].copy().view(np.uint16).reshape(n).astype(np.int64) + 1
    offs = np.frombuffer(data, dtype=np.uint32, count=n, offset=8 + n * 12).astype(np.int64)
    words = np.zeros((n, WORDS_PER_CONTAINER), dtype=np.uint64)
    for i in range(n):
        off, typ, card = int(offs[i]), int(typs[i]), int(cards[i])
        w8 = words[i].view(np.uint8)
        if typ == 1:  # array
            if off + 2 * card > len(buf):
                raise RoaringError("container offset out of bounds")
            vals = np.frombuffer(data, dtype=np.uint16, count=card, offset=off).astype(np.int64)
            np.bitwise_or.at(
                words[i], vals // 64, np.uint64(1) << (vals % 64).astype(np.uint64)
            )
        elif typ == 2:  # bitmap
            if off + 8192 > len(buf):
                raise RoaringError("container offset out of bounds")
            w8[:] = buf[off : off + 8192]
        elif typ == 3:  # run
            if off + 2 > len(buf):
                raise RoaringError("container offset out of bounds")
            rc = int(np.frombuffer(data, dtype=np.uint16, count=1, offset=off)[0])
            if off + 2 + 4 * rc > len(buf):
                raise RoaringError("container offset out of bounds")
            runs = np.frombuffer(data, dtype=np.uint16, count=2 * rc, offset=off + 2).reshape(rc, 2)
            bits = np.zeros(CONTAINER_BITS, dtype=bool)
            for start, last in runs.astype(np.int64):
                bits[start : last + 1] = True
            words[i] = np.packbits(bits, bitorder="little").view(np.uint64)
        else:
            raise RoaringError("unknown container type")
    return keys, words, flags


def _decode_official(data: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """Official 32-bit roaring (RoaringFormatSpec) -> dense containers
    with 16-bit keys widened to 64 (reference readOffsets/readWithRuns,
    roaring/unmarshal_binary.go)."""
    buf = memoryview(data)
    if len(buf) < 4:
        raise RoaringError("truncated roaring data")
    cookie16 = int.from_bytes(buf[:2], "little")
    has_runs = cookie16 == COOKIE_OFFICIAL_RUNS
    pos = 0
    if has_runs:
        n = (int.from_bytes(buf[2:4], "little")) + 1
        pos = 4
        run_flag_bytes = (n + 7) // 8
        if len(buf) < pos + run_flag_bytes:
            raise RoaringError("truncated roaring data")
        run_flags = np.unpackbits(
            np.frombuffer(buf[pos:pos + run_flag_bytes], dtype=np.uint8),
            bitorder="little")[:n]
        pos += run_flag_bytes
    else:
        if len(buf) < 8:
            raise RoaringError("truncated roaring data")
        n = int.from_bytes(buf[4:8], "little")
        pos = 8
        run_flags = np.zeros(n, dtype=np.uint8)
    if len(buf) < pos + 4 * n:
        raise RoaringError("truncated roaring data")
    desc = np.frombuffer(buf[pos:pos + 4 * n], dtype=np.uint16).reshape(n, 2)
    keys16 = desc[:, 0].astype(np.int64)
    cards = desc[:, 1].astype(np.int64) + 1
    pos += 4 * n
    # offset header present unless (runs format and n < 4)
    if not has_runs or n >= 4:
        if len(buf) < pos + 4 * n:
            raise RoaringError("truncated roaring data")
        pos += 4 * n  # offsets unused: containers are contiguous anyway
    keys = keys16.astype(np.uint64)
    words = np.zeros((n, WORDS_PER_CONTAINER), dtype=np.uint64)
    for i in range(n):
        card = int(cards[i])
        if run_flags[i]:
            if len(buf) < pos + 2:
                raise RoaringError("truncated roaring data")
            rc = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
            if len(buf) < pos + 4 * rc:
                raise RoaringError("truncated roaring data")
            runs = np.frombuffer(buf[pos:pos + 4 * rc],
                                 dtype=np.uint16).reshape(rc, 2)
            pos += 4 * rc
            bits = np.zeros(CONTAINER_BITS, dtype=bool)
            # official runs are (start, length-1)
            for start, length in runs.astype(np.int64):
                bits[start:start + length + 1] = True
            words[i] = np.packbits(bits, bitorder="little").view(np.uint64)
        elif card <= 4096:  # array container
            if len(buf) < pos + 2 * card:
                raise RoaringError("truncated roaring data")
            vals = np.frombuffer(buf[pos:pos + 2 * card],
                                 dtype=np.uint16).astype(np.int64)
            pos += 2 * card
            np.bitwise_or.at(words[i], vals // 64,
                             np.uint64(1) << (vals % 64).astype(np.uint64))
        else:  # bitmap container
            if len(buf) < pos + 8192:
                raise RoaringError("truncated roaring data")
            words[i].view(np.uint8)[:] = np.frombuffer(
                buf[pos:pos + 8192], dtype=np.uint8)
            pos += 8192
    return keys, words, 0


# --------------------------------------------------------------- encode


def encode(keys: np.ndarray, words: np.ndarray, flags: int = 0) -> bytes:
    """Serialize dense containers -> roaring bytes.  keys must be sorted
    ascending and unique; empty containers are dropped."""
    keys = np.asarray(keys, dtype=np.uint64)
    words = np.ascontiguousarray(words, dtype=np.uint64).reshape(-1, WORDS_PER_CONTAINER)
    if len(keys) != len(words):
        raise ValueError("keys and words length mismatch")
    if len(keys) > 1 and not (keys[:-1] < keys[1:]).all():
        raise ValueError("keys must be sorted ascending and unique")
    return _encode_py(keys, words, flags)


def _container_stats(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cardinality, maximal-run count) of every dense container
    (uint64[n, 1024]), by word algebra: a run starts at each set bit
    whose lower neighbour is clear."""
    w = words.view(np.uint32)
    cards = np.bitwise_count(w).sum(axis=1, dtype=np.int64)
    carry = np.zeros_like(w)
    carry[:, 1:] = w[:, :-1] >> np.uint32(31)
    rises = w & ~((w << np.uint32(1)) | carry)
    return cards, np.bitwise_count(rises).sum(axis=1, dtype=np.int64)


def _encode_py(keys: np.ndarray, words: np.ndarray, flags: int) -> bytes:
    plans = []
    cards, n_runs = _container_stats(words)
    for i in range(len(keys)):
        card, runs = int(cards[i]), int(n_runs[i])
        if card == 0:
            continue
        w = words[i]
        typ = _WIRE_TYPE[pick_kind(card, runs)]
        bits = starts = ends = None
        if typ != 2:  # only array and run containers need the bits
            bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        if typ == 3:
            starts = np.nonzero(np.diff(np.concatenate(([0], bits))) == 1)[0]
            ends = np.nonzero(np.diff(np.concatenate((bits, [0]))) == -1)[0]
        plans.append((int(keys[i]), card, typ, runs, w, bits, starts, ends))

    out = bytearray()
    out += int(MAGIC).to_bytes(2, "little")
    out += bytes([0, flags])
    out += len(plans).to_bytes(4, "little")
    for key, card, typ, _, _, _, _, _ in plans:
        out += int(key).to_bytes(8, "little")
        out += int(typ).to_bytes(2, "little")
        out += int(card - 1).to_bytes(2, "little")
    offset = 8 + len(plans) * 12 + len(plans) * 4
    for _, card, typ, runs, _, _, _, _ in plans:
        if offset > 0xFFFFFFFF:
            raise RoaringError(_ERRORS[-6])
        out += int(offset).to_bytes(4, "little")
        offset += {1: 2 * card, 2: 8192, 3: 2 + 4 * runs}[typ]
    for _, card, typ, runs, w, bits, starts, ends in plans:
        if typ == 1:
            out += np.nonzero(bits)[0].astype(np.uint16).tobytes()
        elif typ == 2:
            out += w.tobytes()
        else:
            out += int(runs).to_bytes(2, "little")
            pairs = np.empty((runs, 2), dtype=np.uint16)
            pairs[:, 0] = starts
            pairs[:, 1] = ends
            out += pairs.tobytes()
    return bytes(out)


def payload_stats(data: bytes) -> tuple[int, int] | None:
    """Cheap (n_containers, n_set_bits) from the descriptive headers
    alone — no container expansion.  Lets ingest choose between the
    dense container merge (cost ∝ containers x 1024 words) and the
    position-space merge (cost ∝ set bits) before paying either.
    Returns None when the header can't be parsed (caller falls back to
    the dense path, which owns the error reporting)."""
    try:
        if len(data) < 8:
            return None
        cookie16 = int.from_bytes(data[:2], "little")
        cookie32 = int.from_bytes(data[:4], "little")
        if cookie16 == MAGIC:
            n = int.from_bytes(data[4:8], "little")
            if len(data) < 8 + n * 12:
                return None
            desc = np.frombuffer(data, dtype=np.uint8, count=n * 12,
                                 offset=8).reshape(n, 12)
            cards = (desc[:, 10:12].copy().view(np.uint16)
                     .astype(np.int64) + 1)
            return n, int(cards.sum())
        if cookie16 == COOKIE_OFFICIAL_RUNS:
            n = int.from_bytes(data[2:4], "little") + 1
            pos = 4 + (n + 7) // 8
        elif cookie32 == COOKIE_OFFICIAL:
            n = int.from_bytes(data[4:8], "little")
            pos = 8
        else:
            return None
        if len(data) < pos + 4 * n:
            return None
        desc = np.frombuffer(data, dtype=np.uint16, count=2 * n,
                             offset=pos).reshape(n, 2)
        return n, int((desc[:, 1].astype(np.int64) + 1).sum())
    except Exception:  # noqa: BLE001 — stats are advisory only
        return None


def decode_positions(data: bytes,
                     max_positions: int = 1 << 28) -> np.ndarray:
    """Parse serialized roaring -> sorted absolute bit positions
    (u64[n_bits]) WITHOUT materializing dense 1024-word blocks — the
    sparse-ingest fast path (the analog of the reference's streamed
    ImportRoaringBits iterator, roaring/roaring.go:1511, which likewise
    walks containers without densifying arrays).  Raises RoaringError
    when the ACTUAL emitted count would exceed ``max_positions`` —
    descriptor cardinalities are untrusted (a hostile run container can
    lie small); callers fall back to the chunk-bounded dense path."""
    keys, words, _flags = decode(data)
    return containers_to_positions(keys, words)


# ------------------------------------------------- position conversion


def positions_to_containers(positions) -> tuple[np.ndarray, np.ndarray]:
    """Sorted absolute bit positions -> (keys, dense words) containers."""
    pos = np.asarray(positions, dtype=np.uint64)
    if len(pos) == 0:
        return np.empty(0, np.uint64), np.empty((0, WORDS_PER_CONTAINER), np.uint64)
    keys = np.unique(pos >> np.uint64(16))
    slot = np.searchsorted(keys, pos >> np.uint64(16))
    words = np.zeros((len(keys), WORDS_PER_CONTAINER), dtype=np.uint64)
    low = pos & np.uint64(0xFFFF)
    flat_idx = slot * WORDS_PER_CONTAINER + (low >> np.uint64(6)).astype(np.int64)
    np.bitwise_or.at(
        words.reshape(-1), flat_idx, np.uint64(1) << (low & np.uint64(63))
    )
    return keys, words


def containers_to_positions(keys: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Inverse of positions_to_containers: sorted absolute positions."""
    out = []
    for i in range(len(keys)):
        bits = np.unpackbits(words[i].view(np.uint8), bitorder="little")
        nz = np.nonzero(bits)[0].astype(np.uint64)
        out.append((np.uint64(int(keys[i]) << 16)) + nz)
    if not out:
        return np.empty(0, dtype=np.uint64)
    return np.concatenate(out)
