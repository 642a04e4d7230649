"""Chunking and KVC payload serialization: the port's own copy of the
parts of ``repro/core/chunking.py`` the serving engine and the fabric
need.

* chunk striping (paper §3.1): ``split_chunks``, ``num_chunks``,
  ``join_chunks``, ``chunk_server``, ``replica_delta``;
* the ``SKYM`` wire format (``arrays_to_bytes`` / ``bytes_to_arrays``),
  byte for byte: magic | version | n | per array (dtype tag, shape, raw);
* the ``SKYC`` container headers the fabric reads without decoding a
  body: ``is_delta_payload``, ``delta_info``, ``cat_payloads``,
  ``split_cat_payload`` and ``payload_raw_bytes``;
* ``decode_payload_arrays`` for raw ``SKYM`` payloads;
* ``PayloadCodec`` for ``"f32"`` (verbatim arrays).

Arrays may be numpy arrays or torch tensors.  numpy has no bfloat16
here, so a bf16 tensor is written as its raw 2-byte words under the tag
``b"bfloat16"`` -- the bytes ``repro`` writes for a bf16 payload -- and
that tag decodes straight to a ``torch.bfloat16`` tensor.  Other dtypes
decode to numpy arrays.  The module imports ``torch`` only to decode a
bf16 array, so the fabric (``protocol.py``) runs without it.

Decoding a quantized ``SKYC`` body (int8, int4, ``+delta``) waits for
ROADMAP.md queue 1, 'int8/int4/+delta payload codecs'; it raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import struct
import sys
from dataclasses import dataclass

import numpy as np

_MAGIC = b"SKYM"
_VERSION = 1
_CODEC_MAGIC = b"SKYC"
_CODEC_VERSION = 1
# container kinds under the SKYC magic
_KIND_ENC = 1     # quantized array container (codec id + per-array header)
_KIND_DELTA = 2   # back-pointer + inner payload for one block's new tokens
_KIND_CAT = 3     # ordered segments whose decoded arrays concatenate
# per-array storage tag inside an ENC container: verbatim bytes
_STORE_RAW = 0
_BF16 = b"bfloat16"
_CODECS_TODO = ("the quantized payload codecs wait for ROADMAP.md queue 1, "
                "'int8/int4/+delta payload codecs'")


def split_chunks(data: bytes, chunk_bytes: int) -> list[bytes]:
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    if not data:
        return [b""]
    return [data[i : i + chunk_bytes] for i in range(0, len(data), chunk_bytes)]


def num_chunks(total_bytes: int, chunk_bytes: int) -> int:
    if total_bytes == 0:
        return 1
    return -(-total_bytes // chunk_bytes)


def join_chunks(chunks: list[bytes]) -> bytes:
    return b"".join(chunks)


def chunk_server(chunk_id: int, num_servers: int) -> int:
    """Virtual server (0-based) for a chunk: chunk_id mod n (paper §3.1).

    This is *replica 0*'s placement.  Under k-replica placement the
    other copies keep the same virtual server but live on satellites
    offset from its home by ``replica_delta`` -- replication changes
    where copies sit on the torus, never which server owns a chunk.
    """
    return chunk_id % num_servers


def replica_delta(
    replica: int, num_planes: int, sats_per_plane: int
) -> tuple[int, int]:
    """Torus offset ``(d_plane, d_slot)`` of replica ``replica``'s home
    satellite from the chunk's base (replica-0) server satellite.

    Replicas walk plane-first: replica ``r`` sits ``r`` planes east of
    the base until the planes are exhausted, then spills one slot south
    and keeps walking planes.  So every replica of a chunk is in a
    different orbital plane whenever ``k <= num_planes`` (a whole-plane
    outage takes out at most one copy), and no two replicas share a
    satellite whenever ``k <= num_planes * sats_per_plane``.
    """
    if replica < 0:
        raise ValueError("replica index must be >= 0")
    return replica % num_planes, replica // num_planes


# ---------------------------------------------------------------------------
# KVC payload serialization.
# ---------------------------------------------------------------------------

def _dtype_from_name(name: str) -> np.dtype:
    """The numpy dtype of a header's dtype tag.  numpy has no bfloat16
    here: its tag maps to a 2-byte void item, which is all a header-only
    scan needs."""
    if name == _BF16.decode():
        return np.dtype((np.void, 2))
    try:
        return np.dtype(name)
    except TypeError:
        # a corrupt / truncated header names no dtype at all
        raise ValueError(f"unknown dtype name {name!r}") from None


def _tag_and_raw(a) -> tuple[bytes, tuple[int, ...], bytes]:
    """(dtype tag, shape, raw C-order bytes) of one array or tensor."""
    torch = sys.modules.get("torch")   # no tensor exists before its import
    if torch is not None and isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return _BF16, tuple(a.shape), a.view(torch.int16).numpy().tobytes()
        a = a.numpy()
    a = np.asarray(a)
    return a.dtype.str.encode(), a.shape, a.tobytes()


def arrays_to_bytes(arrays) -> bytes:
    """Serialize a list of arrays: magic | version | n | per-array header."""
    parts = [_MAGIC, struct.pack("<HI", _VERSION, len(arrays))]
    for a in arrays:
        dt, shape, raw = _tag_and_raw(a)
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", len(shape)))
        parts.append(struct.pack(f"<{len(shape)}q", *shape))
        parts.append(struct.pack("<q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _from_raw(tag: bytes, raw: bytes, shape):
    if tag == _BF16:
        import torch

        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=_dtype_from_name(tag.decode())).reshape(
        shape)


def bytes_to_arrays(data: bytes) -> list:
    if data[:4] != _MAGIC:
        raise ValueError("not a SkyMemory KVC payload")
    out = []
    try:
        ver, n = struct.unpack_from("<HI", data, 4)
        if ver != _VERSION:
            raise ValueError(f"unsupported KVC payload version {ver}")
        off = 10
        for _ in range(n):
            (dlen,) = struct.unpack_from("<B", data, off)
            off += 1
            tag = data[off: off + dlen]
            off += dlen
            (ndim,) = struct.unpack_from("<B", data, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", data, off)
            off += 8 * ndim
            (rlen,) = struct.unpack_from("<q", data, off)
            off += 8
            out.append(_from_raw(tag, data[off: off + rlen], shape))
            off += rlen
    except struct.error as e:
        raise ValueError(f"corrupt KVC payload: {e}") from e
    return out


# -- SKYC container headers (the bodies wait for the codecs) ----------------

def _codec_kind(data: bytes) -> int | None:
    """SKYC container kind, or None for anything else (incl. SKYM)."""
    if len(data) < 7 or data[:4] != _CODEC_MAGIC:
        return None
    ver, kind = struct.unpack_from("<HB", data, 4)
    if ver != _CODEC_VERSION:
        raise ValueError(f"unsupported KVC codec version {ver}")
    return kind


def is_delta_payload(data: bytes) -> bool:
    return _codec_kind(data) == _KIND_DELTA


def delta_info(data: bytes) -> tuple[bytes, int, bytes]:
    """``(prev_hash, prev_tokens, inner_payload)`` of a delta payload."""
    if _codec_kind(data) != _KIND_DELTA:
        raise ValueError("not a delta payload")
    try:
        (hlen,) = struct.unpack_from("<B", data, 7)
        prev_hash = data[8:8 + hlen]
        if len(prev_hash) != hlen:
            raise ValueError("corrupt delta payload: truncated hash")
        (prev_tokens,) = struct.unpack_from("<q", data, 8 + hlen)
    except struct.error as e:
        raise ValueError(f"corrupt delta payload: {e}") from e
    return prev_hash, prev_tokens, data[16 + hlen:]


def cat_payloads(parts: list[bytes]) -> bytes:
    """Concatenation container: an ordered list of payloads (a cumulative
    base followed by delta segments) whose decoded arrays concatenate
    along the token axis.  Nested cats flatten; a single segment returns
    itself (no wrapper)."""
    segs: list[bytes] = []
    for p in parts:
        segs.extend(split_cat_payload(p) if is_cat_payload(p) else [p])
    if not segs:
        raise ValueError("cat of zero payloads")
    if len(segs) == 1:
        return segs[0]
    out = [_CODEC_MAGIC, struct.pack("<HB", _CODEC_VERSION, _KIND_CAT),
           struct.pack("<I", len(segs))]
    for s in segs:
        out.append(struct.pack("<q", len(s)))
        out.append(s)
    return b"".join(out)


def is_cat_payload(data: bytes) -> bool:
    return _codec_kind(data) == _KIND_CAT


def split_cat_payload(data: bytes) -> list[bytes]:
    if _codec_kind(data) != _KIND_CAT:
        raise ValueError("not a cat payload")
    segs: list[bytes] = []
    try:
        n, = struct.unpack_from("<I", data, 7)
        off = 11
        for _ in range(n):
            (slen,) = struct.unpack_from("<q", data, off)
            off += 8
            if slen < 0 or off + slen > len(data):
                raise ValueError("corrupt cat payload: truncated segment")
            segs.append(data[off:off + slen])
            off += slen
    except struct.error as e:
        raise ValueError(f"corrupt cat payload: {e}") from e
    return segs


def payload_raw_bytes(data: bytes) -> int:
    """Dtype-true bytes ``data`` decodes to -- a header-only scan (bodies
    are skipped, nothing dequantizes), so Set/Get paths can account
    ``bytes_raw`` vs ``bytes_encoded`` per block at negligible cost.
    Best-effort: anything unparseable (the fabric also stores opaque
    test bytes) counts at face value instead of raising."""
    try:
        return _payload_raw_bytes(data)
    except (ValueError, IndexError, UnicodeDecodeError, struct.error):
        return len(data)


def _payload_raw_bytes(data: bytes) -> int:
    kind = _codec_kind(data)
    if kind == _KIND_DELTA:
        return payload_raw_bytes(delta_info(data)[2])
    if kind == _KIND_CAT:
        return sum(payload_raw_bytes(s) for s in split_cat_payload(data))
    total = 0
    if kind == _KIND_ENC:
        n, = struct.unpack_from("<I", data, 8)
        off = 12
        for _ in range(n):
            (dlen,) = struct.unpack_from("<B", data, off)
            off += 1
            dt = _dtype_from_name(data[off:off + dlen].decode())
            off += dlen
            (ndim,) = struct.unpack_from("<B", data, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", data, off)
            off += 8 * ndim
            (store,) = struct.unpack_from("<B", data, off)
            off += 1
            size = int(np.prod(shape, dtype=np.int64)) if ndim else 1
            total += size * dt.itemsize
            if store == _STORE_RAW:
                (rlen,) = struct.unpack_from("<q", data, off)
                off += 8 + rlen
            else:
                seg, n_segs = struct.unpack_from("<ii", data, off)
                off += 8 + 4 * n_segs * (shape[-1] if ndim else 1)
                (qlen,) = struct.unpack_from("<q", data, off)
                off += 8 + qlen
        return total
    if data[:4] == _MAGIC:
        _, n = struct.unpack_from("<HI", data, 4)
        off = 10
        for _ in range(n):
            (dlen,) = struct.unpack_from("<B", data, off)
            off += 1 + dlen
            (ndim,) = struct.unpack_from("<B", data, off)
            off += 1 + 8 * ndim
            (rlen,) = struct.unpack_from("<q", data, off)
            off += 8 + rlen
            total += rlen
        return total
    return len(data)


def decode_payload_arrays(data: bytes) -> list:
    """Decode a raw ``SKYM`` payload back to arrays."""
    if data[:4] == _CODEC_MAGIC:
        raise NotImplementedError(_CODECS_TODO)
    return bytes_to_arrays(data)


@dataclass(frozen=True)
class PayloadCodec:
    """How a KVC payload's bytes are produced: ``"f32"`` ships the arrays
    verbatim in the ``SKYM`` format (whatever their dtype)."""

    name: str = "f32"

    def __post_init__(self) -> None:
        if self.name != "f32":
            raise NotImplementedError(_CODECS_TODO)

    @classmethod
    def parse(cls, spec) -> "PayloadCodec":
        """``None`` / ``"f32"`` / a ready ``PayloadCodec``."""
        if isinstance(spec, cls):
            return spec
        return cls("f32" if spec is None else spec)

    def encode(self, arrays) -> bytes:
        return arrays_to_bytes(arrays)
