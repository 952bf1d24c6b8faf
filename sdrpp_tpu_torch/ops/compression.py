"""Baseband sample-stream compression (the server wire format).

The counterpart of ``sdrpp_tpu.ops.compression`` (reference:
core/src/dsp/compression/sample_stream_compressor.h:26-60 /
sample_stream_decompressor.h:13-36): a header {compressionType u16,
pcmType u16, scaler f32} followed by block-max-normalized i8/i16
quantization (or raw f32). ``quantize_block`` and ``dequantize_block``
run on the input tensor's device; ``pack_frame`` and ``unpack_frame`` are
host functions over numpy.

The quantizer takes the JAX function's float32 steps in its order
(``32768.0 / max`` as an IEEE division, the product, round half to even,
the clip), so the bytes on the wire are the JAX package's.

NOTE (faithful quirk): the reference's scaler is the block's maximum
SIGNED value (volk_32f_index_max), not the absolute max — negative samples
larger in magnitude saturate. Replicated exactly.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = [
    "PCM_TYPE_I8", "PCM_TYPE_I16", "PCM_TYPE_F32",
    "quantize_block", "dequantize_block", "pack_frame", "unpack_frame",
]

PCM_TYPE_I8 = 0
PCM_TYPE_I16 = 1
PCM_TYPE_F32 = 2

_HDR = struct.Struct("<HHf")
# pcm type -> (full scale, integer type)
_INT = {PCM_TYPE_I8: (128.0, torch.int8), PCM_TYPE_I16: (32768.0, torch.int16)}


def quantize_block(x: torch.Tensor, pcm_type: int):
    """Quantize a complex64 block [..., n] on its device -> (interleaved
    ints [..., 2n], float32 scaler [...]).

    Matches the reference's VOLK convert path: scale = (128 or 32768) /
    max(interleaved floats), rounded, saturated.
    """
    flat = torch.view_as_real(x).reshape(*x.shape[:-1], -1)
    if pcm_type == PCM_TYPE_F32:
        return flat, torch.zeros((), dtype=torch.float32, device=x.device)
    if pcm_type not in _INT:
        raise ValueError(pcm_type)
    full, dtype = _INT[pcm_type]
    info = torch.iinfo(dtype)
    max_val = flat.amax(dim=-1)  # signed max (reference quirk)
    # a tensor numerator: ``python_scalar / tensor`` is reciprocal-then-
    # multiply in torch, not the IEEE division the JAX function makes
    scale = torch.full_like(max_val, full) / max_val
    q = torch.round(flat * scale[..., None]).clamp_(info.min, info.max)
    return q.to(dtype), max_val


def dequantize_block(q: torch.Tensor, scaler, pcm_type: int) -> torch.Tensor:
    """Inverse: ints + scaler -> complex64 block (decompressor.h:17-33)."""
    flat = q.to(torch.float32)
    if pcm_type in _INT:
        scaler = torch.as_tensor(scaler, dtype=torch.float32, device=q.device)
        flat = flat * (scaler / _INT[pcm_type][0])
    elif pcm_type != PCM_TYPE_F32:
        raise ValueError(pcm_type)
    pairs = flat.reshape(*flat.shape[:-1], -1, 2).contiguous()
    return torch.view_as_complex(pairs)


def pack_frame(x, pcm_type: int) -> bytes:
    """Complex64 block -> wire bytes (8-byte header + payload). A numpy
    block is quantized on the host, a tensor on its own device; the frame
    is put together on the host."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.complex64))
    if pcm_type == PCM_TYPE_F32:
        return _HDR.pack(0, PCM_TYPE_F32, 0.0) + x.cpu().numpy().tobytes()
    q, scaler = quantize_block(x, pcm_type)
    return (_HDR.pack(0, pcm_type, float(scaler))
            + q.cpu().numpy().tobytes())


def unpack_frame(frame: bytes) -> np.ndarray:
    """Host: wire bytes -> complex64 block."""
    comp, pcm_type, scaler = _HDR.unpack_from(frame, 0)
    payload = frame[8:]
    if pcm_type == PCM_TYPE_F32:
        return np.frombuffer(payload, np.complex64)
    dt = np.int8 if pcm_type == PCM_TYPE_I8 else np.int16
    q = torch.from_numpy(np.frombuffer(payload, dt).copy())
    return dequantize_block(q, np.float32(scaler), pcm_type).numpy()
