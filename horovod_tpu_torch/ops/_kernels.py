"""The port's hand-written Hopper kernels: build, binding, wrappers, and the
plain PyTorch version beside each kernel.

Six CUDA C++ kernels replace the three Pallas kernels of
``horovod_tpu/ops/flash_attention.py``, and ``wire_codec.cu`` holds the wire
codecs of the compressed allreduce (``compression/codecs.py`` wraps them):

==================  ========================  ==============================
kernel              source (``csrc/``)        replaces
==================  ========================  ==============================
``flash_fwd_sm90``  ``flash_fwd_sm90.cu``     ``_fwd_kernel`` (o and lse)
``flash_dq_sm90``   ``flash_dq_sm90.cu``      ``_dq_kernel`` (dq)
``flash_dkv_sm90``  ``flash_dkv_sm90.cu``     ``_dkv_kernel`` (dk, dv)
``flash_fwd``       ``flash_fwd.cu``          ``_fwd_kernel``
``flash_dq``        ``flash_dq.cu``           ``_dq_kernel``
``flash_dkv``       ``flash_dkv.cu``          ``_dkv_kernel``
==================  ========================  ==============================

The ``*_sm90`` kernels run their products on the tensor cores (``wgmma``,
tiles brought by TMA) and take bf16 with head_dim 64 or 128; the others do
fp32 FMAs on the CUDA cores and take fp32 or bf16 with any head_dim up to
128. ``_variant`` chooses between the two designs of each kernel from the
dtype and head_dim alone; a kernel that fails to build or launch raises.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``. The build runs at first use,
all sources at once, into ``csrc/build/``; a library's name carries a hash of
its source, every header in ``csrc/`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. The TMA kernels reach
``cuTensorMapEncodeTiled`` through the runtime's driver entry point, so no
library links ``-lcuda``.

Each wrapper takes tensors in the kernel's layout (``[B, S, H, D]``
contiguous, lse and delta ``[B, H, S]`` fp32). On a CUDA tensor it launches
its kernel on the current stream, or raises; on a CPU tensor it runs the
plain version of the kernel it would launch (``*_plain``), which the tests
also use as the reference. ``LAUNCHES`` counts kernel launches per kernel and
nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {"flash_fwd_sm90": "flash_fwd_sm90.cu",
           "flash_dq_sm90": "flash_dq_sm90.cu",
           "flash_dkv_sm90": "flash_dkv_sm90.cu",
           "flash_fwd": "flash_fwd.cu", "flash_dq": "flash_dq.cu",
           "flash_dkv": "flash_dkv.cu", "wire_codec": "wire_codec.cu"}
FLASH_KERNELS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
                 "flash_fwd", "flash_dq", "flash_dkv")
# the wire codecs' kernels (wire_codec.cu; wrappers in compression/codecs.py):
# an entry point per codec
CODEC_KERNELS = tuple(f"wire_{op}_{codec}" for codec in ("bf16", "int8", "fp8")
                      for op in ("encode", "decode_accumulate",
                                 "ef_roundtrip"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in FLASH_KERNELS + CODEC_KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_libs: dict = {}
_build_log: dict = {}
_lock = threading.Lock()


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (PATH, CUDA_HOME or "
                       "/usr/local/cuda)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel that has no up-to-date library yet, all in
    parallel (one ``nvcc`` per source), and return ``{name: path}``. Raises
    with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    jobs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        _build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def build_log() -> dict:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of each kernel built by this process."""
    return dict(_build_log)


def _lib(name: str):
    with _lock:
        if not _libs:
            ptr = ctypes.c_void_p
            i32, f32 = ctypes.c_int, ctypes.c_float
            ints = [i32] * 5 + [f32, i32, i32, i32, ptr]  # B S H Hkv D scale causal dtypes stream
            fwd, dq, dkv = ([ptr] * n + ints for n in (5, 7, 8))
            argtypes = {"flash_fwd_sm90": fwd, "flash_dq_sm90": dq,
                        "flash_dkv_sm90": dkv, "flash_fwd": fwd,
                        "flash_dq": dq, "flash_dkv": dkv}
            i64 = ctypes.c_longlong
            wire = {"hvt_wire_encode": [ptr, ptr, i64, i32, ptr],
                    "hvt_wire_decode_accumulate": [ptr, ptr, i64, i32, i32,
                                                   ptr],
                    "hvt_wire_ef_roundtrip": [ptr, ptr, i64, i32, ptr]}
            for n, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fname, args in (wire.items() if n == "wire_codec"
                                    else [(f"hvt_{n}", argtypes[n])]):
                    fn = getattr(lib, fname)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                if n == "flash_fwd_sm90":
                    lib.hvt_wgmma_probe.argtypes = [ptr] * 5
                    lib.hvt_wgmma_probe.restype = ctypes.c_int
                lib.hvt_cuda_error_string.argtypes = [ctypes.c_int]
                lib.hvt_cuda_error_string.restype = ctypes.c_char_p
                _libs[n] = lib
    return _libs[name]


def _run(name: str, tensors, q, k, scale, causal, second_dtype):
    """Launch kernel ``name`` on ``tensors`` (pointers in C order) and count
    the launch; raise if the launch failed."""
    lib = _lib(name)
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"hvt_{name}")(
            *[t.data_ptr() for t in tensors], b, s, h, k.shape[2], d,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[second_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _check(q, k, v, out_dtype, dout=None, lse=None, delta=None):
    """Validate what the kernels take before any pointer reaches them:
    [B, S, H, D] q and [B, S, H_kv, D] k, v of one dtype (fp32 or bf16),
    H % H_kv == 0, 0 < D <= 128, D % 8 == 0; o/dO in q's dtype or fp32;
    dO [B, S, H, D]; lse, delta fp32 [B, H, S]; all contiguous on one CUDA
    device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,H,D] and k, v [B,S,H_kv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"n_heads ({h}) must be divisible by n_kv_heads "
                         f"({k.shape[2]})")
    if not (0 < d <= 128 and d % 8 == 0):
        raise ValueError(f"the flash kernels take head_dim in 8..128 in "
                         f"steps of 8; got {d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernels take fp32 or bf16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"o/dO must be in q's dtype or fp32; got {out_dtype}")
    if dout is not None and (dout.shape != q.shape or dout.dtype != out_dtype):
        raise ValueError(f"dO must be {out_dtype} of q's shape "
                         f"{tuple(q.shape)}; got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (b, h, s)):
            raise ValueError(f"{name} must be fp32 [B,H,S] = {(b, h, s)}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in (q, k, v, dout, lse, delta):
        if t is not None and (t.device != q.device or t.device.type != "cuda"
                              or not t.is_contiguous()):
            raise ValueError("the flash kernels take contiguous tensors on "
                             "one CUDA device")


# --------------------------------------------------------------------------
# plain versions (dense scores; the same arithmetic and rounding points)
# --------------------------------------------------------------------------

def _bhsd(x, group=1):
    """[B, S, H, D] → fp32 [B, H·group, S, D]; head hi of the result is head
    hi // group of ``x`` (GQA)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(qh, kh, scale, causal):
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        pos = torch.arange(n, device=s.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    return s


def flash_fwd_plain(q, k, v, scale, causal, out_dtype):
    """Plain version of ``flash_fwd``: o [B, S, H, D] in ``out_dtype`` and
    lse [B, H, S] fp32. Differentiable; p is rounded to v's dtype before
    p·v, as the kernels do."""
    group = q.shape[2] // k.shape[2]
    qh, kh, vh = _bhsd(q), _bhsd(k, group), _bhsd(v, group)
    s = _scores(qh, kh, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    o = torch.matmul(p, vh).to(out_dtype)
    return o.transpose(1, 2).contiguous(), lse


def _probs_and_ds(q, k, v, dout, lse, delta, scale, causal):
    group = q.shape[2] // k.shape[2]
    qh, kh, vh = _bhsd(q), _bhsd(k, group), _bhsd(v, group)
    p = torch.exp(_scores(qh, kh, scale, causal) - lse[..., None])
    dp = torch.matmul(_bhsd(dout), vh.transpose(-1, -2))
    return qh, kh, p, p * (dp - delta[..., None])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def flash_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                   round_operands=False):
    """Plain version of ``flash_dq``: dq [B, S, H, D] in q's dtype.

    ``round_operands=True`` is the plain version of ``flash_dq_sm90``: dO
    and the ds operand of ds k are rounded to bf16, as the tensor cores take
    them. Without it, ds k takes fp32 ds, as ``_dq_kernel`` and
    ``flash_dq`` do."""
    if round_operands:
        dout = dout.to(torch.bfloat16)
    _, kh, _, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale, causal)
    if round_operands:
        ds = _bf16(ds)
    dq = torch.matmul(ds, kh) * scale
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal,
                    round_operands=False):
    """Plain version of ``flash_dkv``: dk, dv [B, S, H_kv, D] in k's dtype,
    each K/V head's gradient summed over its query group.

    ``round_operands=True`` is the plain version of ``flash_dkv_sm90``: the
    operands of p^T dO and ds^T q are rounded to bf16 (dO is bf16 already
    on that route), as the tensor cores take them. Without it, both products
    take fp32 p and ds, as ``_dkv_kernel`` and ``flash_dkv`` do."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if round_operands:
        dout = dout.to(torch.bfloat16)
    qh, _, p, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale, causal)
    if round_operands:
        p, ds = _bf16(p), _bf16(ds)
    dv = torch.matmul(p.transpose(-1, -2), _bhsd(dout))
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale

    def per_kv_head(x, dtype):
        x = x.reshape(b, h_kv, h // h_kv, s, d).sum(dim=2)
        return x.to(dtype).transpose(1, 2).contiguous()

    return per_kv_head(dk, k.dtype), per_kv_head(dv, v.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _variant(dtype, d) -> str:
    """Which design of each kernel takes q/k/v of this dtype and head_dim:
    "sm90" (tensor cores) for bf16 with D 64 or 128, else "simt"."""
    return "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "simt"


def _kernel(base, q, variant):
    """The kernel of ``base`` ("flash_fwd", "flash_dq" or "flash_dkv") that
    takes q: ``variant`` None chooses by ``_variant``; "sm90" or "simt" asks
    for one design and raises if it does not take q."""
    chosen = _variant(q.dtype, q.shape[-1])
    if variant is not None:
        if variant not in ("sm90", "simt"):
            raise ValueError(f"variant must be None, 'sm90' or 'simt'; got "
                             f"{variant!r}")
        if variant == "sm90" and chosen != "sm90":
            raise ValueError(f"the sm90 kernels take bf16 with head_dim 64 "
                             f"or 128; got {q.dtype}, head_dim "
                             f"{q.shape[-1]}")
        chosen = variant
    return base + "_sm90" if chosen == "sm90" else base


def flash_fwd(q, k, v, scale, causal, out_dtype, variant=None):
    """Attention forward: (o [B, S, H, D] in ``out_dtype``, lse [B, H, S])."""
    name = _kernel("flash_fwd", q, variant)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, out_dtype)
    _check(q, k, v, out_dtype)
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _run(name, (q, k, v, o, lse), q, k, scale, causal, out_dtype)
    return o, lse


def flash_dq(q, k, v, dout, lse, delta, scale, causal, variant=None):
    """Query gradient: dq [B, S, H, D] in q's dtype. On the sm90 route ds
    is rounded to bf16 before ds k, and an fp32 dO is rounded to bf16 (see
    ``flash_dq_plain``)."""
    name = _kernel("flash_dq", q, variant)
    sm90 = name.endswith("_sm90")
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                              round_operands=sm90)
    _check(q, k, v, dout.dtype, dout, lse, delta)
    if sm90:
        dout = dout.to(torch.bfloat16)
    dq = torch.empty_like(q)
    _run(name, (q, k, v, dout, lse, delta, dq), q, k, scale, causal,
         dout.dtype)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, scale, causal, variant=None):
    """Key and value gradients: dk, dv [B, S, H_kv, D] in k's dtype. On the
    sm90 route p and ds are rounded to bf16 before their products, and an
    fp32 dO is rounded to bf16 (see ``flash_dkv_plain``)."""
    name = _kernel("flash_dkv", q, variant)
    sm90 = name.endswith("_sm90")
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal,
                               round_operands=sm90)
    _check(q, k, v, dout.dtype, dout, lse, delta)
    if sm90:
        dout = dout.to(torch.bfloat16)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(name, (q, k, v, dout, lse, delta, dk, dv), q, k, scale, causal,
         dout.dtype)
    return dk, dv


def wgmma_probe(a, b):
    """One 64 x 64 x 64 product on the tensor cores through the building
    blocks of the sm90 kernels (TMA, wgmma descriptors, the register A
    operand): returns (a @ b^T, bf16(a @ b^T) @ b) in fp32 for bf16 [64, 64]
    CUDA tensors. A check for the card tests; not on any path."""
    if a.shape != (64, 64) or b.shape != (64, 64) or a.device.type != "cuda" \
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("wgmma_probe takes bf16 [64, 64] CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c1 = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    c2 = torch.empty_like(c1)
    lib = _lib("flash_fwd_sm90")
    with torch.cuda.device(a.device):
        rc = lib.hvt_wgmma_probe(a.data_ptr(), b.data_ptr(), c1.data_ptr(),
                                 c2.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wgmma probe launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    return c1, c2
