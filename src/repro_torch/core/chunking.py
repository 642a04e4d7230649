"""KVC payload serialization: the port's own copy of the parts of
``repro/core/chunking.py`` the paged engine needs.

* the ``SKYM`` wire format (``arrays_to_bytes`` / ``bytes_to_arrays``),
  byte for byte: magic | version | n | per array (dtype tag, shape, raw);
* ``decode_payload_arrays`` for raw ``SKYM`` payloads;
* ``PayloadCodec`` for ``"f32"`` (verbatim arrays).

Arrays may be numpy arrays or torch tensors.  numpy has no bfloat16
here, so a bf16 tensor is written as its raw 2-byte words under the tag
``b"bfloat16"`` -- the bytes ``repro`` writes for a bf16 payload -- and
that tag decodes straight to a ``torch.bfloat16`` tensor.  Other dtypes
decode to numpy arrays.

The quantized ``SKYC`` codecs (int8, int4, ``+delta``) wait for ROADMAP.md
queue 1, 'int8/int4/+delta payload codecs'; they raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

_MAGIC = b"SKYM"
_VERSION = 1
_CODEC_MAGIC = b"SKYC"
_BF16 = b"bfloat16"
_CODECS_TODO = ("the quantized payload codecs wait for ROADMAP.md queue 1, "
                "'int8/int4/+delta payload codecs'")


def _tag_and_raw(a) -> tuple[bytes, tuple[int, ...], bytes]:
    """(dtype tag, shape, raw C-order bytes) of one array or tensor."""
    if isinstance(a, torch.Tensor):
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
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    try:
        dt = np.dtype(tag.decode())
    except TypeError:
        raise ValueError(f"unknown dtype name {tag!r}") from None
    return np.frombuffer(raw, dtype=dt).reshape(shape)


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
