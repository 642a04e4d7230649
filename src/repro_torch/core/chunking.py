"""Chunking and KVC payload serialization: the port's own copy of
``repro/core/chunking.py`` (paper §3.1 and §5's quantized blocks).

* chunk striping (paper §3.1): ``split_chunks``, ``num_chunks``,
  ``join_chunks``, ``chunk_server``, ``replica_delta``;
* the ``SKYM`` wire format (``arrays_to_bytes`` / ``bytes_to_arrays``),
  byte for byte: magic | version | n | per array (dtype tag, shape, raw);
* the versioned codec layer under the ``SKYC`` magic, byte for byte:
  ``PayloadCodec`` (``"f32"``, ``"int8"``, ``"int4"``, each optionally
  ``+delta``), ``encode_arrays`` (symmetric per-last-axis-channel
  quantization with one scale row per ``block_tokens`` chunk of the
  token axis; int4 packs two codes per byte; integer and bool arrays are
  stored verbatim), ``make_delta_payload`` (one block's own tokens
  behind a back-pointer to the previous block), ``cat_payloads`` (a
  reassembled chain), the header scans (``is_delta_payload``,
  ``delta_info``, ``split_cat_payload``, ``payload_raw_bytes``) and
  ``decode_payload_arrays``, which decodes any of them;
* the reference's int8 helpers (``QuantizedArray``, ``quantize_int8``,
  ``dequantize_int8``, ``quantized_to_bytes``, and
  ``bytes_to_dequantized``, which also decodes the legacy ``SKYM``
  ``[q, scale, ...]`` pair payloads).

Arrays may be numpy arrays or torch tensors.  numpy has no bfloat16
here, so a bf16 tensor is written as its raw 2-byte words under the tag
``b"bfloat16"`` -- the bytes ``repro`` writes for a bf16 payload -- and
quantized from its exact f32 values; that tag decodes straight to a
``torch.bfloat16`` tensor (a quantized one is dequantized in f32 and
rounded to nearest-even, as ``ml_dtypes`` rounds).  Other dtypes decode
to numpy arrays.  Quantization runs in numpy on the host.  The module
imports ``torch`` only to decode a bf16 array, so the fabric
(``protocol.py``) runs without it.
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

_CODEC_IDS = {"int8": 1, "int4": 2}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}
_QMAX = {"int8": 127.0, "int4": 7.0}
# per-array storage tags inside an ENC container
_STORE_RAW = 0    # verbatim bytes (integer and bool arrays)
_STORE_Q = 1      # quantized codes + per-(chunk, channel) scale table
_BF16 = b"bfloat16"


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


# ---------------------------------------------------------------------------
# int8 KVC quantization (paper §5 used 8-bit quantized KVC blocks).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantizedArray:
    q: np.ndarray       # int8 values
    scale: np.ndarray   # per-last-axis-channel float32 scale


def quantize_int8(a) -> QuantizedArray:
    """Symmetric per-channel (last axis) int8 quantization of an array or
    tensor (a bf16 tensor from its exact f32 values)."""
    a = np.asarray(_host_array(a)[1], dtype=np.float32)
    amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)), keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return QuantizedArray(q=q, scale=scale)


def dequantize_int8(qa: QuantizedArray) -> np.ndarray:
    return qa.q.astype(np.float32) * qa.scale


def quantized_to_bytes(arrays) -> bytes:
    """Serialize ``arrays`` int8-quantized, recording each array's source
    dtype in the codec header so ``bytes_to_dequantized`` restores it
    (a bf16 tensor comes back a bf16 tensor)."""
    return encode_arrays(arrays, PayloadCodec("int8"))


def bytes_to_dequantized(data: bytes) -> list:
    """Decode a quantized payload back to (dequantized) arrays.

    ``SKYC`` payloads restore each array's recorded source dtype; legacy
    ``SKYM`` [q, scale, q, scale, ...] payloads (written before the codec
    header existed) decode to float32, as the reference's do: that format
    never recorded the source dtype."""
    if data[:4] == _CODEC_MAGIC:
        return decode_payload_arrays(data)
    flat = bytes_to_arrays(data)
    if len(flat) % 2:
        raise ValueError("corrupt quantized payload")
    return [dequantize_int8(QuantizedArray(q=flat[i], scale=flat[i + 1]))
            for i in range(0, len(flat), 2)]


# -- SKYC containers --------------------------------------------------------

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




# ---------------------------------------------------------------------------
# The versioned payload codec layer.
# ---------------------------------------------------------------------------

def _host_array(a) -> tuple[bytes, np.ndarray]:
    """(dtype tag, host numpy array) of one array or tensor.  A bf16
    tensor keeps its tag and yields its exact f32 values, which is what
    quantization reads (numpy has no bfloat16 here)."""
    torch = sys.modules.get("torch")   # no tensor exists before its import
    if torch is not None and isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return _BF16, a.float().cpu().numpy()
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.dtype.str.encode(), a


def _quant_geometry(shape: tuple[int, ...]) -> tuple[int, int, int]:
    """(token_axis, n_tokens, channels) used for per-chunk scale tables.

    KVC payload arrays put the token axis at axis 1 (``[L, T, Hkv, hd]``
    dense K/V) and channels on the last axis; lower-rank arrays fall back
    to axis 0 -- the segmentation is self-consistent between encode and
    decode either way, which is all correctness needs.
    """
    axis = 1 if len(shape) >= 3 else 0
    return axis, shape[axis], shape[-1]


def _quantize_segmented(
    a: np.ndarray, qmax: float, seg: int
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-last-axis-channel quantization with one scale row
    per ``seg``-token chunk of the token axis: returns ``(codes, scales)``
    where ``codes`` is int8 in [-qmax, qmax] with ``a``'s shape and
    ``scales`` is float32 ``[n_segs, channels]``."""
    orig_shape = a.shape
    af = np.asarray(a, dtype=np.float32)
    if af.ndim < 2:
        af = af.reshape(1, af.size)
    axis, n_tok, chans = _quant_geometry(af.shape)
    seg = seg if seg and seg > 0 else max(n_tok, 1)
    n_segs = max(1, -(-n_tok // seg)) if n_tok else 1
    scales = np.ones((n_segs, chans), np.float32)
    q = np.zeros(af.shape, np.int8)
    red = tuple(range(af.ndim - 1))
    sl: list[slice] = [slice(None)] * af.ndim
    for s in range(n_segs):
        sl[axis] = slice(s * seg, (s + 1) * seg)
        part = af[tuple(sl)]
        if part.size == 0:
            continue
        amax = np.max(np.abs(part), axis=red, keepdims=True)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q[tuple(sl)] = np.clip(
            np.round(part / scale), -qmax, qmax).astype(np.int8)
        scales[s] = scale.reshape(chans)
    return q.reshape(orig_shape), scales


def _dequantize_segmented(q: np.ndarray, scales: np.ndarray, seg: int,
                          tag: bytes):
    """Codes and their scale table back to the source dtype ``tag``:
    dequantized in f32, then cast (a bf16 source becomes a
    ``torch.bfloat16`` tensor, rounded to nearest-even)."""
    orig_shape = q.shape
    qf = q.astype(np.float32)
    if qf.ndim < 2:
        qf = qf.reshape(1, qf.size)
    axis, n_tok, chans = _quant_geometry(qf.shape)
    seg = seg if seg and seg > 0 else max(n_tok, 1)
    n_segs = max(1, -(-n_tok // seg)) if n_tok else 1
    if scales.shape != (n_segs, chans):
        raise ValueError("corrupt codec payload: scale table shape "
                         f"{scales.shape} != {(n_segs, chans)}")
    out = np.empty(qf.shape, np.float32)
    sl: list[slice] = [slice(None)] * qf.ndim
    for s in range(n_segs):
        sl[axis] = slice(s * seg, (s + 1) * seg)
        out[tuple(sl)] = qf[tuple(sl)] * scales[s]
    out = out.reshape(orig_shape)
    if tag == _BF16:
        import torch

        return torch.from_numpy(out).to(torch.bfloat16)
    return out.astype(_dtype_from_name(tag.decode()))


def _pack_int4(q: np.ndarray) -> bytes:
    """[-7, 7] codes -> two offset nibbles per byte (odd tails padded)."""
    flat = (q.reshape(-1).astype(np.int16) + 8).astype(np.uint8)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return (flat[0::2] | (flat[1::2] << 4)).tobytes()


def _unpack_int4(data: bytes, size: int) -> np.ndarray:
    if len(data) != (size + 1) // 2:
        raise ValueError("corrupt codec payload: truncated int4 codes")
    b = np.frombuffer(data, np.uint8)
    out = np.empty(b.size * 2, np.int8)
    out[0::2] = (b & 0x0F).astype(np.int16) - 8
    out[1::2] = (b >> 4).astype(np.int16) - 8
    return out[:size]


@dataclass(frozen=True)
class PayloadCodec:
    """How a KVC payload's bytes are produced.

    ``name``: ``"f32"`` (verbatim, the ``SKYM`` wire format), ``"int8"``
    or ``"int4"`` (symmetric per-channel quantization).  ``block_tokens``
    is the scale-table chunk along the token axis (0 = one table for the
    whole tensor) AND the block size delta chains are hashed at.
    ``delta`` opts cumulative dense payloads into delta encoding -- it
    requires ``block_tokens`` so back-pointers can be recomputed from the
    token chain.  Decoding never needs a codec (payloads are
    self-describing); this object only shapes *encoding* and the router's
    bytes-per-token price model.
    """

    name: str = "f32"
    block_tokens: int = 0
    delta: bool = False

    def __post_init__(self) -> None:
        if self.name not in ("f32", "int8", "int4"):
            raise ValueError(f"unknown payload codec {self.name!r}")
        if self.delta and self.block_tokens <= 0:
            raise ValueError("delta encoding needs block_tokens > 0")

    @classmethod
    def parse(cls, spec, block_tokens: int = 0) -> "PayloadCodec":
        """``None`` / ``"f32"`` / ``"int8"`` / ``"int4"`` / ``"int8+delta"``
        / ``"int4+delta"`` / a ready ``PayloadCodec`` -> a codec whose
        chunked scale tables (and delta hashing) use ``block_tokens``."""
        if isinstance(spec, cls):
            return spec
        if spec is None:
            spec = "f32"
        base, _, suffix = spec.partition("+")
        if suffix not in ("", "delta"):
            raise ValueError(f"unknown payload codec {spec!r}")
        return cls(base, block_tokens, delta=suffix == "delta")

    @property
    def quantized(self) -> bool:
        return self.name != "f32"

    def bytes_per_value(self, src_itemsize: int) -> float:
        """Encoded payload bytes per stored value -- the router's
        codec-derived size model (scale tables and headers are noise at
        KVC payload sizes and are deliberately not modeled)."""
        if self.name == "int8":
            return 1.0
        if self.name == "int4":
            return 0.5
        return float(src_itemsize)

    def encode(self, arrays) -> bytes:
        return encode_arrays(arrays, self)


def encode_arrays(arrays, codec: PayloadCodec) -> bytes:
    """Serialize ``arrays`` under ``codec``.  ``f32`` emits the ``SKYM``
    format byte for byte; quantized codecs emit a ``SKYC`` container
    recording the codec id and, per array, the source dtype, shape, and
    per-chunk scale table.  Integer/bool arrays (e.g. an already-int8
    pool's pages) are always stored verbatim -- re-quantizing quantized
    codes would corrupt them."""
    if not codec.quantized:
        return arrays_to_bytes(arrays)
    qmax = _QMAX[codec.name]
    parts = [_CODEC_MAGIC,
             struct.pack("<HBB", _CODEC_VERSION, _KIND_ENC,
                         _CODEC_IDS[codec.name]),
             struct.pack("<I", len(arrays))]
    for a in arrays:
        dt, a = _host_array(a)
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        if a.dtype.kind in "iub":
            raw = a.tobytes()
            parts.append(struct.pack("<B", _STORE_RAW))
            parts.append(struct.pack("<q", len(raw)))
            parts.append(raw)
            continue
        q, scales = _quantize_segmented(a, qmax, codec.block_tokens)
        body = (_pack_int4(q) if codec.name == "int4" else q.tobytes())
        parts.append(struct.pack("<B", _STORE_Q))
        parts.append(struct.pack("<ii", codec.block_tokens, scales.shape[0]))
        parts.append(scales.tobytes())
        parts.append(struct.pack("<q", len(body)))
        parts.append(body)
    return b"".join(parts)


def _decode_enc(data: bytes) -> list:
    out: list = []
    try:
        codec_id, = struct.unpack_from("<B", data, 7)
        name = _CODEC_NAMES.get(codec_id)
        if name is None:
            raise ValueError(f"unknown KVC codec id {codec_id}")
        n, = struct.unpack_from("<I", data, 8)
        off = 12
        for _ in range(n):
            (dlen,) = struct.unpack_from("<B", data, off)
            off += 1
            tag = data[off:off + dlen]
            dt = _dtype_from_name(tag.decode())
            off += dlen
            (ndim,) = struct.unpack_from("<B", data, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", data, off)
            off += 8 * ndim
            (store,) = struct.unpack_from("<B", data, off)
            off += 1
            if store == _STORE_RAW:
                (rlen,) = struct.unpack_from("<q", data, off)
                off += 8
                if off + rlen > len(data):
                    raise ValueError("truncated")
                out.append(_from_raw(tag, data[off:off + rlen], shape))
                off += rlen
                continue
            if store != _STORE_Q:
                raise ValueError(f"unknown storage tag {store}")
            seg, n_segs = struct.unpack_from("<ii", data, off)
            off += 8
            chans = shape[-1] if ndim else 1
            slen = 4 * n_segs * chans
            if n_segs < 1 or off + slen > len(data):
                raise ValueError("truncated")
            scales = np.frombuffer(
                data[off:off + slen], np.float32).reshape(n_segs, chans)
            off += slen
            (qlen,) = struct.unpack_from("<q", data, off)
            off += 8
            if off + qlen > len(data):
                raise ValueError("truncated")
            size = int(np.prod(shape, dtype=np.int64)) if ndim else 1
            if name == "int4":
                q = _unpack_int4(data[off:off + qlen], size)
            else:
                if qlen != size:
                    raise ValueError("truncated")
                q = np.frombuffer(data[off:off + qlen], np.int8)
            off += qlen
            out.append(_dequantize_segmented(
                q.reshape(shape), scales, seg, tag))
    except struct.error as e:
        raise ValueError(f"corrupt codec payload: {e}") from e
    return out


def make_delta_payload(inner: bytes, prev_hash: bytes,
                       prev_tokens: int) -> bytes:
    """Wrap ``inner`` (this block's *own* tokens, already encoded) with a
    back-pointer: the previous block's hash and how many tokens its
    cumulative payload covers."""
    return b"".join([
        _CODEC_MAGIC, struct.pack("<HB", _CODEC_VERSION, _KIND_DELTA),
        struct.pack("<B", len(prev_hash)), prev_hash,
        struct.pack("<q", prev_tokens), inner,
    ])


def _concat_tokens(pieces: list):
    """Concatenate one array's segments along the token axis (1 for rank
    >= 3, else 0); bf16 segments are tensors, the rest numpy arrays."""
    axis = 1 if pieces[0].ndim >= 3 else 0
    torch = sys.modules.get("torch")
    if torch is not None and any(isinstance(p, torch.Tensor) for p in pieces):
        return torch.cat([torch.as_tensor(p) for p in pieces], dim=axis)
    return np.concatenate(pieces, axis=axis)


def decode_payload_arrays(data: bytes) -> list:
    """Decode ANY payload this module can emit back to arrays: ``SKYM``,
    quantized ``SKYC`` containers (source dtype restored), a bare delta
    segment (its own tokens only), or a cat container (the segments'
    arrays concatenated position-wise along the token axis)."""
    kind = _codec_kind(data)
    if kind is None:
        return bytes_to_arrays(data)
    if kind == _KIND_ENC:
        return _decode_enc(data)
    if kind == _KIND_DELTA:
        return decode_payload_arrays(delta_info(data)[2])
    if kind == _KIND_CAT:
        seg_arrays = [decode_payload_arrays(s)
                      for s in split_cat_payload(data)]
        n = len(seg_arrays[0])
        if any(len(sa) != n for sa in seg_arrays):
            raise ValueError("corrupt cat payload: ragged segments")
        return [_concat_tokens([sa[i] for sa in seg_arrays])
                for i in range(n)]
    raise ValueError(f"unknown KVC container kind {kind}")
