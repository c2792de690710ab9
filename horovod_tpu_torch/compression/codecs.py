"""The wire codecs: plain PyTorch versions and the wrappers of their CUDA
kernels (``csrc/wire_codec.cu``), the port's copy of the JAX package's C++
codecs (``horovod_tpu/csrc/codecs.{h,cc}``), bit for bit.

- ``bf16``: round-to-nearest-even truncation, 2 wire bytes an element.
- ``int8`` and ``fp8`` (OCP e4m3): blocks of 256 fp32 elements, each block's
  fp32 absmax scale in-band ahead of its codes, so a full block is 260 wire
  bytes and a tail of ``rem`` elements ``4 + rem``.

Every function takes a flat contiguous fp32 tensor. On a CUDA tensor a
wrapper launches its kernel on the current stream, or raises; on a CPU
tensor it runs the plain version (``*_plain``), which the tests also hold
against the C++ codecs and the card holds the kernels against.
``ops/_kernels.LAUNCHES`` counts the launches, one name per codec and entry
point (``wire_encode_int8``, ...).

The rounding points are the C++ codecs': the scale is ``absmax / 127`` (or
``/ 448``) by IEEE division, a tensor by a tensor (PyTorch may turn a
division by a Python number into a product with its reciprocal), and the
codes take ``x * (1 / scale)``. An absmax ignores NaN, a non-finite one
becomes ``FLT_MAX / 2``. The fp8 code of a NaN product carries the sign x86
gives it (the C++ codec's platform): the NaN operand's own, or negative for
``0 * inf``.
"""

from __future__ import annotations

import math

import torch

from horovod_tpu_torch.compression import CODEC_IDS

BLOCK = 256                 # fp32 elements a scaled block holds
WIRE_BLOCK = 4 + BLOCK      # its wire bytes: the scale, then the codes
LOSSY = ("bf16", "int8", "fp8")
_MAX_CODE = {"int8": 127.0, "fp8": 448.0}
_HALF_FLT_MAX = torch.finfo(torch.float32).max * 0.5


def wire_bytes(codec: str, n: int) -> int:
    """Wire bytes of ``n`` fp32 elements under ``codec`` (the C++
    ``CompressedSize``; ``none`` moves 4 bytes an element)."""
    if codec == "bf16":
        return 2 * n
    if codec in _MAX_CODE:
        full, rem = divmod(n, BLOCK)
        return full * WIRE_BLOCK + (4 + rem if rem else 0)
    return 4 * n


def _check(codec, *tensors):
    if codec not in LOSSY:
        raise ValueError(f"unknown lossy wire codec {codec!r} "
                         f"(known: {LOSSY})")
    for t in tensors:
        if t is not None and (t.dim() != 1 or not t.is_contiguous()):
            raise ValueError("the wire codecs take flat contiguous tensors")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _bits(x):
    """The fp32 bits of ``x`` as int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(b):
    """fp32 from bits in [0, 2^32) held as int64."""
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _blocks(x):
    """``x`` zero-padded to whole blocks: ([blocks, 256], elements)."""
    n = x.numel()
    nb = -(-n // BLOCK)
    if nb * BLOCK != n:
        x = torch.cat([x, x.new_zeros(nb * BLOCK - n)])
    return x.view(nb, BLOCK), n


def _scales(xb, codec):
    """Each block's scale and the reciprocal the codes take (0 where the
    scale is 0)."""
    a = xb.abs()
    amax = torch.where(torch.isnan(a), torch.zeros_like(a), a).amax(1)
    amax = torch.where(torch.isfinite(amax), amax,
                       torch.full_like(amax, _HALF_FLT_MAX))
    pos = amax > 0
    scale = torch.where(pos, amax / torch.full_like(amax, _MAX_CODE[codec]),
                        torch.zeros_like(amax))
    inv = torch.where(pos, torch.ones_like(scale) / torch.where(
        pos, scale, torch.ones_like(scale)), torch.zeros_like(scale))
    return scale, inv


def _fp8_codes(x, p):
    """OCP e4m3 codes of the products ``p = x * inv`` (the C++
    ``FloatToE4m3``), as int64."""
    nan_p = torch.isnan(p)
    bits = torch.where(nan_p, torch.where(torch.isnan(x), _bits(x),
                                          torch.full_like(_bits(x), 1 << 31)),
                       _bits(p))
    sign = (bits >> 24) & 0x80
    a = p.abs()
    special = nan_p | (a >= 448.0) | (a < 2.0 ** -10)
    a_safe = torch.where(special, torch.ones_like(a), a)
    e = ((_bits(a_safe) >> 23) & 0xFF) - 127
    e = e.clamp(min=-6)
    inv_step = _from_bits((130 - e) << 23)
    q = torch.round(a_safe * inv_step)
    big = q >= 16.0
    q = torch.where(big, q * 0.5, q)
    e = torch.where(big, e + 1, e)
    iq = q.to(torch.int64)
    code = torch.where(iq < 8, sign | iq, sign | (((e + 7) << 3) | (iq - 8)))
    sat = nan_p | (a >= 448.0) | (e > 8) | ((e == 8) & (q > 14.0))
    code = torch.where(a < 2.0 ** -10, sign, code)
    return torch.where(sat & ~(a < 2.0 ** -10), sign | 0x7E, code)


def _fp8_table(device):
    """fp32 value of every e4m3 code (the C++ ``E4m3ToFloat``)."""
    vals = []
    for b in range(256):
        sign = -1.0 if b & 0x80 else 1.0
        exp, man = (b >> 3) & 0xF, b & 7
        if exp == 0xF and man == 7:
            vals.append(sign * 448.0)
        elif exp == 0:
            vals.append(sign * math.ldexp(man, -9))
        else:
            vals.append(sign * math.ldexp(1.0 + man / 8.0, exp - 7))
    return torch.tensor(vals, dtype=torch.float32, device=device)


def encode_plain(x, codec):
    """Plain version of ``encode``: the wire stream (uint8) of ``x``."""
    _check(codec, x)
    if codec == "bf16":
        b = _bits(x)
        h = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFFFFFF) >> 16
        return torch.stack([h & 0xFF, h >> 8], 1).to(torch.uint8).reshape(-1)
    xb, n = _blocks(x)
    scale, inv = _scales(xb, codec)
    p = xb * inv[:, None]
    if codec == "int8":
        v = torch.where(torch.isnan(p), torch.full_like(p, 127.0),
                        p.clamp(-127.0, 127.0))
        codes = torch.round(v).to(torch.int8).view(torch.uint8)
    else:
        codes = _fp8_codes(xb, p).to(torch.uint8)
    codes = torch.where((scale > 0)[:, None], codes, torch.zeros_like(codes))
    rows = torch.cat([scale.view(torch.uint8).view(-1, 4), codes], 1)
    return rows.reshape(-1)[:wire_bytes(codec, n)]


def _decode(stream, codec, n):
    stream = stream[:wire_bytes(codec, n)]
    if codec == "bf16":
        h = stream[0::2].to(torch.int64) | (stream[1::2].to(torch.int64) << 8)
        return _from_bits(h << 16)
    nb = -(-n // BLOCK)
    full = torch.zeros(nb * WIRE_BLOCK, dtype=torch.uint8,
                       device=stream.device)
    full[:stream.numel()] = stream
    rows = full.view(nb, WIRE_BLOCK)
    scale = rows[:, :4].contiguous().view(torch.float32)
    codes = rows[:, 4:]
    if codec == "int8":
        vals = codes.view(torch.int8).to(torch.float32)
    else:
        vals = _fp8_table(stream.device)[codes.to(torch.int64)]
    return (vals * scale).reshape(-1)[:n]


def decode_accumulate_plain(stream, codec, n, out, accumulate=False):
    """Plain version of ``decode_accumulate``: ``out`` (fp32, ``n``
    elements) becomes the decoded stream, or the decoded stream is added
    into it."""
    _check(codec, stream, out)
    vals = _decode(stream, codec, n)
    return out.add_(vals) if accumulate else out.copy_(vals)


def roundtrip_plain(x, codec):
    """``decode(encode(x))`` as a new tensor (the C++ ``Roundtrip``)."""
    return _decode(encode_plain(x, codec), codec, x.numel())


def ef_roundtrip_plain(seg, codec, residual=None):
    """Plain version of ``ef_roundtrip``, in place: ``seg += residual``,
    ``seg = roundtrip(seg)``, ``residual = (seg before the roundtrip) -
    seg``; without a residual a plain roundtrip."""
    _check(codec, seg, residual)
    if residual is not None:
        seg.add_(residual)
        saved = seg.clone()
    seg.copy_(roundtrip_plain(seg, codec))
    if residual is not None:
        torch.sub(saved, seg, out=residual)
    return seg


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _launch(op, codec, *args):
    """Launch ``hvt_wire_<op>`` on the current stream and count it; raise
    if the launch failed."""
    from horovod_tpu_torch.ops import _kernels

    lib = _kernels._lib("wire_codec")
    rc = getattr(lib, f"hvt_wire_{op}")(
        *args, CODEC_IDS[codec], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wire_{op}_{codec} kernel launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    _kernels.LAUNCHES[f"wire_{op}_{codec}"] += 1


def _on_card(*tensors):
    device = tensors[0].device
    for t in tensors:
        if t is not None and (t.device != device or t.dtype not in (
                torch.float32, torch.uint8)):
            raise ValueError("the wire codec kernels take fp32 values and "
                             "uint8 streams on one device")
    return device.type != "cpu"


def encode(x, codec):
    """The wire stream (uint8, ``wire_bytes(codec, n)`` bytes) of the flat
    fp32 tensor ``x``."""
    _check(codec, x)
    if not _on_card(x):
        return encode_plain(x, codec)
    out = torch.empty(wire_bytes(codec, x.numel()), dtype=torch.uint8,
                      device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            _launch("encode", codec, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def decode_accumulate(stream, codec, n, out=None, accumulate=False):
    """Decode the first ``n`` elements' stream into ``out`` (fp32, made
    when None), or add them into it when ``accumulate``; returns ``out``."""
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs out")
        out = torch.empty(n, dtype=torch.float32, device=stream.device)
    _check(codec, stream, out)
    if out.numel() != n or stream.numel() < wire_bytes(codec, n):
        raise ValueError(f"out must hold {n} elements and the stream "
                         f"{wire_bytes(codec, n)} bytes; got {out.numel()} "
                         f"and {stream.numel()}")
    if not _on_card(stream, out):
        return decode_accumulate_plain(stream, codec, n, out, accumulate)
    if codec == "bf16" and stream.data_ptr() % 2:
        raise ValueError("a bf16 stream must start at an even address")
    if n:
        with torch.cuda.device(out.device):
            _launch("decode_accumulate", codec, stream.data_ptr(),
                    out.data_ptr(), n, int(bool(accumulate)))
    return out


def ef_roundtrip(seg, codec, residual=None):
    """In place: ``seg += residual``, ``seg = decode(encode(seg))``,
    ``residual = (seg before the roundtrip) - seg``; without a residual a
    plain roundtrip. Returns ``seg``."""
    _check(codec, seg, residual)
    if residual is not None and residual.shape != seg.shape:
        raise ValueError("the residual must have seg's shape")
    if not _on_card(seg, residual):
        return ef_roundtrip_plain(seg, codec, residual)
    if seg.numel():
        with torch.cuda.device(seg.device):
            _launch("ef_roundtrip", codec, seg.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    seg.numel())
    return seg
