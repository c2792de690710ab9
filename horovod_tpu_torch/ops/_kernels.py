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
tiles brought by TMA) and take what ``SM90_ROUTES`` lists, keyed by q's
dtype and o's (dO's) dtype: bf16 and fp16 q at every head_dim 1..512 with
an o in q's dtype (above 256 each warpgroup or block owns one column half
of the head), and at every head_dim 1..256 with the sequence ring's fp32 o
(``flash_dq_sm90`` and ``flash_dkv_sm90`` take an fp32 dO as two terms of
q's dtype); fp32 q with an fp32 o at every head_dim 1..256 (products as
3xTF32: each operand split into two TF32 terms, three products summed in
fp32). fp16's
range is narrow (normals from 2^-14, at most 65504), so on fp16 q the dq
and dkv kernels take dO times a power of two 2^e from dO's largest
magnitude (``dout_scale``; the wrappers pass that magnitude as a device
scalar) and multiply their results by 2^-e. The kernels take head_dims in
steps of 8: the wrappers give them
any other head_dim zero-padded to the next multiple of 8 (``pad_head_dim``;
zero columns add nothing to q k^T and give zero columns of o, dq, dk and
dv, which are cut off), and a head_dim that is not a whole number of
128-byte panels runs padded further by TMA's zero fill. The others (SIMT)
do fp32 FMAs on the CUDA cores and take fp32 or bf16 with any head_dim up
to 128; no route reaches them, and all three stay built and checked on the
card as ``variant="simt"``. A shape that no tensor-core kernel takes (head
dims above 512, above 256 with fp32 q or an fp32 o, or a 2-byte o of
another dtype than q's) raises ``ValueError`` on a CUDA tensor, naming
each route's range; ``use_flash="auto"`` takes the kernels only where
``sm90_takes`` says all three do. A kernel that fails to build or launch
raises.

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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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
            fwd, dq, dkv, dq90, dkv90 = ([ptr] * n + ints
                                         for n in (5, 7, 8, 8, 9))
            # the sm90 dq and dkv take dO's largest magnitude after delta
            argtypes = {"flash_fwd_sm90": fwd, "flash_dq_sm90": dq90,
                        "flash_dkv_sm90": dkv90, "flash_fwd": fwd,
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
                    lib.hvt_wgmma_probe.argtypes = [ptr] * 4 + [i32, ptr]
                    lib.hvt_wgmma_probe.restype = ctypes.c_int
                    lib.hvt_wgmma_probe_wide.argtypes = [ptr] * 6 + [i32, ptr]
                    lib.hvt_wgmma_probe_wide.restype = ctypes.c_int
                    lib.hvt_wgmma_probe_wide_tf32.argtypes = \
                        [ptr] * 5 + [i32, i32, ptr]
                    lib.hvt_wgmma_probe_wide_tf32.restype = ctypes.c_int
                if n in FLASH_KERNELS:
                    lib.hvt_last_launch_attributes.argtypes = [ptr, ptr]
                    lib.hvt_last_launch_attributes.restype = ctypes.c_int
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
            *[None if t is None else t.data_ptr() for t in tensors],
            b, s, h, k.shape[2], d,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[second_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def launch_attributes(name: str):
    """(registers a thread, shared-memory bytes a block) of the instance of
    flash kernel ``name`` launched last (``cudaFuncGetAttributes``), as
    chip_smoke.py records them beside each timing."""
    regs, smem = ctypes.c_int(), ctypes.c_int()
    lib = _lib(name)
    rc = lib.hvt_last_launch_attributes(ctypes.byref(regs),
                                        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{name}: no launch attributes: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    return regs.value, smem.value


def _check(q, k, v, out_dtype, dout=None, lse=None, delta=None,
           kernel="flash_fwd_sm90"):
    """Validate what ``kernel`` takes before any pointer reaches it:
    [B, S, H, D] q and [B, S, H_kv, D] k, v of one dtype (fp32, bf16 or
    fp16),
    H % H_kv == 0; o/dO in q's dtype or fp32; a head_dim that ``kernel``
    takes with these dtypes (a tensor-core kernel: ``SM90_ROUTES``; a SIMT
    kernel: up to 128), in steps of 8 (the wrappers pad the others); dO
    [B, S, H, D]; lse, delta fp32 [B, H, S]; all contiguous on one CUDA
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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernels take fp32, bf16 or fp16 q/k/v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"o/dO must be in q's dtype or fp32; got {out_dtype}")
    if not kernel.endswith("_sm90"):
        if q.dtype == _FP16:
            raise ValueError(f"{kernel} (SIMT) takes fp32 or bf16; got fp16")
        if not (0 < d <= SIMT_MAX_HEAD_DIM and d % 8 == 0):
            raise ValueError(f"{kernel} (SIMT) takes head_dim 8..128 in "
                             f"steps of 8; got {d}")
    elif _variant(kernel[:-len("_sm90")], q.dtype, d, out_dtype) != "sm90":
        raise ValueError(_refusal(kernel, q.dtype, out_dtype, d))
    if d % 8:
        raise ValueError(f"{kernel} takes head_dim in steps of 8 (the "
                         f"wrappers pad the others); got {d}")
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


def _round(x, dtype):
    """``x`` rounded to nearest ``dtype`` (bf16 or fp16), as fp32."""
    return x.to(dtype).float()


def _terms(x, dtype):
    """fp32 x as the fp32 sum of two terms of ``dtype``, hi = r(x) and lo =
    r(x - hi), as the sm90 kernels split an fp32 dO (exact in fp32)."""
    hi = _round(x, dtype)
    return hi + _round(x - hi, dtype)


def dout_scale(dout):
    """The power of two 2^e by which the sm90 dq and dkv kernels on fp16 q
    multiply dO (and delta) before they round anything derived from it to
    fp16: e = -(the exponent of frexp(max |dO|)), so max |dO| 2^e lies in
    [0.5, 1); e within ±120, and 2^0 for an all-zero or non-finite dO. A
    0-d fp32 tensor on dO's device (no host sync); exact, and so is its
    inverse, by which the kernels multiply dq, dk and dv
    (``csrc/sm90.cuh``, dout_scale)."""
    return _scale_of(dout_amax(dout))


def dout_amax(dout):
    """dO's largest magnitude as a 0-d fp32 tensor: what the fp16 kernels
    are given."""
    return torch.linalg.vector_norm(dout, float("inf"), dtype=torch.float32)


def _scale_of(amax):
    _, e = torch.frexp(amax)
    e = torch.where(torch.isfinite(amax) & (amax > 0), e.clamp(-120, 120),
                    torch.zeros_like(e))
    return ((127 - e) << 23).view(torch.float32)


def _operand_dtype(q):
    """The 2-byte type the sm90 kernels round their operands to for q:
    fp16 for fp16 q, else bf16 (also what the plain versions' rounding
    flags mean on fp32 inputs)."""
    return torch.float16 if q.dtype == torch.float16 else torch.bfloat16


def _scaled_dout(q, dout, delta, rounds):
    """(dO, delta, 2^e): fp32 dO and delta times the fp16 kernels' scale
    2^e (``dout_scale``) where they round to fp16, else as they are and
    2^e = 1."""
    if rounds and _operand_dtype(q) == torch.float16:
        s = dout_scale(dout)
        return dout.float() * s, delta * s, s
    return dout, delta, 1.0


def flash_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                   split_dout=False, round_ds=False):
    """Plain version of ``flash_dq``: dq [B, S, H, D] in q's dtype.

    ``split_dout=True`` takes dO as the sum of two terms, hi = r(dO) and lo
    = r(dO - hi), and ``round_ds=True`` rounds the ds operand of ds k, r
    rounding to fp16 for fp16 q and to bf16 otherwise: both together are
    the plain version of ``flash_dq_sm90`` with bf16 or fp16 q, which takes
    its operands on the tensor cores in q's dtype (a dO in q's dtype is its
    own hi term, exact; an fp32 dO, the sequence ring's, it splits into the
    two). On fp16 q they also take dO and delta times ``dout_scale(dO)``
    and dq times its inverse, as the kernel does. Without them every
    operand stays fp32, as ``_dq_kernel``, ``flash_dq`` and
    ``flash_dq_sm90`` with fp32 q (3xTF32) take them."""
    rnd = _operand_dtype(q)
    split = split_dout and dout.dtype == torch.float32
    dout, delta, s = _scaled_dout(q, dout, delta, split_dout or round_ds)
    if split:
        dout = _terms(dout, rnd)
    _, kh, _, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale, causal)
    if round_ds:
        ds = _round(ds, rnd)
    dq = torch.matmul(ds, kh) * scale / s
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal,
                    split_dout=False, round_operands=False):
    """Plain version of ``flash_dkv``: dk, dv [B, S, H_kv, D] in k's dtype,
    each K/V head's gradient summed over its query group.

    ``split_dout=True`` takes dO as the sum of two terms, hi = r(dO) and lo
    = r(dO - hi), and ``round_operands=True`` rounds p and ds before p^T dO
    and ds^T q, r rounding to fp16 for fp16 q and to bf16 otherwise: both
    together are the plain version of ``flash_dkv_sm90`` with bf16 or fp16
    q, which takes its operands on the tensor cores in q's dtype (a dO in
    q's dtype is its own hi term, exact; an fp32 dO, the sequence ring's, it
    splits into the two). On fp16 q they also take dO and delta times
    ``dout_scale(dO)`` and dk, dv times its inverse, as the kernel does.
    Without them every operand stays fp32, as ``_dkv_kernel``,
    ``flash_dkv`` and ``flash_dkv_sm90`` with fp32 q (3xTF32) take them."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    rnd = _operand_dtype(q)
    split = split_dout and dout.dtype == torch.float32
    dout, delta, sc = _scaled_dout(q, dout, delta,
                                   split_dout or round_operands)
    if split:
        dout = _terms(dout, rnd)
    qh, _, p, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale, causal)
    if round_operands:
        p, ds = _round(p, rnd), _round(ds, rnd)
    dv = torch.matmul(p.transpose(-1, -2), _bhsd(dout)) / sc
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale / sc

    def per_kv_head(x, dtype):
        x = x.reshape(b, h_kv, h // h_kv, s, d).sum(dim=2)
        return x.to(dtype).transpose(1, 2).contiguous()

    return per_kv_head(dk, k.dtype), per_kv_head(dv, v.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

# what each tensor-core kernel takes: {(q's dtype, o's or dO's dtype): the
# head_dims the kernels see, in steps of 8; every head_dim up to the last
# reaches them zero-padded (padded_head_dim)}. Off these routes (ROADMAP):
# head_dims above 512, and above 256 the ring's fp32 o/dO and fp32 q.
HEAD_DIMS = tuple(range(8, 129, 8))         # 1-4 fp32 or 1-2 2-byte panels
WIDE_HEAD_DIMS = tuple(range(136, 257, 8))  # padded widths 192 and 256
XWIDE_HEAD_DIMS = tuple(range(264, 513, 8))  # 384 and 512: 2-byte, o in q's dtype
SIMT_MAX_HEAD_DIM = 128
_BF16, _FP16, _FP32 = torch.bfloat16, torch.float16, torch.float32
SM90_ROUTES = {base: {
    (_BF16, _BF16): HEAD_DIMS + WIDE_HEAD_DIMS + XWIDE_HEAD_DIMS,
    (_BF16, _FP32): HEAD_DIMS + WIDE_HEAD_DIMS,
    (_FP16, _FP16): HEAD_DIMS + WIDE_HEAD_DIMS + XWIDE_HEAD_DIMS,
    (_FP16, _FP32): HEAD_DIMS + WIDE_HEAD_DIMS,
    (_FP32, _FP32): HEAD_DIMS + WIDE_HEAD_DIMS}
    for base in ("flash_fwd", "flash_dq", "flash_dkv")}


def padded_head_dim(d) -> int:
    """The head_dim the kernels see for head_dim ``d``: the next multiple
    of 8."""
    return -(-d // 8) * 8


def pad_head_dim(x, width):
    """``x`` with its last axis zero-padded to ``width`` columns; ``x``
    itself where it has them (no copy)."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _variant(base, dtype, d, out_dtype=None) -> str:
    """Which design of kernel ``base`` ("flash_fwd", "flash_dq" or
    "flash_dkv") takes q/k/v of this dtype and head_dim (padded to the
    next multiple of 8) with o (dO) in ``out_dtype`` (default q's): "sm90"
    (tensor cores) where ``SM90_ROUTES`` lists them, else "simt" (which no
    route reaches: on a CUDA tensor the wrappers raise there)."""
    dims = SM90_ROUTES[base].get((dtype, out_dtype or dtype), ())
    return "sm90" if d > 0 and padded_head_dim(d) in dims else "simt"


def sm90_takes(dtype, head_dim, out_dtype=None) -> bool:
    """Whether all three tensor-core kernels take q of this dtype and
    head_dim with o (so dO) in ``out_dtype`` (default q's)."""
    return all(_variant(base, dtype, head_dim, out_dtype) == "sm90"
               for base in SM90_ROUTES)


def _refusal(name, dtype, out_dtype, d) -> str:
    """What ``name`` takes, each route with its own range of head_dims, and
    what it was given."""
    short = lambda t: str(t).split(".")[-1]
    routes = SM90_ROUTES[name[:-len("_sm90")]]
    takes = [f"{short(q)} q with head_dim "
             + " or ".join(f"1..{routes[q, o][-1]} (o/dO {short(o)})"
                           for o in dict.fromkeys((q, _FP32))
                           if (q, o) in routes)
             for q in (_BF16, _FP16, _FP32)]
    return (f"{name} takes {takes[0]}, {takes[1]} and {takes[2]}; got "
            f"{short(dtype)} q with {short(out_dtype)} o/dO, head_dim {d}")


def _kernel(base, q, variant, out_dtype=None):
    """The kernel of ``base`` for q with o (dO) in ``out_dtype`` (default
    q's): the tensor-core one unless ``variant`` is "simt". Where
    ``SM90_ROUTES`` does not list the inputs it raises ``ValueError``,
    naming the routes, for "sm90" asked for by name and, with ``variant``
    None, for a tensor off the CPU; on a CPU tensor the plain version then
    runs with fp32 operands."""
    if variant not in (None, "sm90", "simt"):
        raise ValueError(f"variant must be None, 'sm90' or 'simt'; got "
                         f"{variant!r}")
    if variant != "simt" and (variant == "sm90" or q.device.type != "cpu") \
            and _variant(base, q.dtype, q.shape[-1], out_dtype) != "sm90":
        raise ValueError(_refusal(base + "_sm90", q.dtype,
                                  out_dtype or q.dtype, q.shape[-1]))
    return base if variant == "simt" else base + "_sm90"


def _rounds_operands(name, q, out_dtype):
    """Whether the plain version of ``name`` rounds its operands as the
    tensor-core kernel does with bf16 or fp16 q (an fp32 dO as two terms of
    q's dtype, ds and p in q's dtype; on fp16 with dO's scale): only on a
    route that kernel takes."""
    return (name.endswith("_sm90") and q.dtype in (_BF16, _FP16)
            and _variant(name[:-len("_sm90")], q.dtype, q.shape[-1],
                         out_dtype) == "sm90")


def _amax_arg(name, q, dout, given):
    """The dO magnitude an sm90 dq or dkv kernel on fp16 q reads (the
    caller's, or dO's own), as a contiguous fp32 device scalar; None for
    every other kernel."""
    if not name.endswith("_sm90") or q.dtype != _FP16:
        return None
    amax = dout_amax(dout) if given is None else given
    return amax.reshape(()).to(device=q.device, dtype=torch.float32)


def flash_fwd(q, k, v, scale, causal, out_dtype, variant=None):
    """Attention forward: (o [B, S, H, D] in ``out_dtype``, lse [B, H, S])."""
    name = _kernel("flash_fwd", q, variant, out_dtype)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, out_dtype)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    if d != dp:
        o, lse = flash_fwd(*(pad_head_dim(t, dp) for t in (q, k, v)), scale,
                           causal, out_dtype, variant)
        return o[..., :d].contiguous(), lse
    _check(q, k, v, out_dtype, kernel=name)
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _run(name, (q, k, v, o, lse), q, k, scale, causal, out_dtype)
    return o, lse


def flash_dq(q, k, v, dout, lse, delta, scale, causal, variant=None,
             dout_amax=None):
    """Query gradient: dq [B, S, H, D] in q's dtype. On the sm90 route with
    bf16 or fp16 q, ds is rounded to q's dtype before ds k and the kernel
    splits an fp32 dO into two terms of q's dtype; on fp16 it scales dO by
    ``dout_scale`` first (see ``flash_dq_plain``). ``dout_amax``: dO's
    largest magnitude where the caller has it (``flash_dkv`` reads the
    same), else it is taken here. With fp32 q every operand stays fp32
    (3xTF32)."""
    name = _kernel("flash_dq", q, variant, dout.dtype)
    rounds = _rounds_operands(name, q, dout.dtype)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, scale, causal,
                              split_dout=rounds, round_ds=rounds)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    if d != dp:
        padded = (pad_head_dim(t, dp) for t in (q, k, v, dout))
        return flash_dq(*padded, lse, delta, scale, causal, variant,
                        dout_amax)[..., :d].contiguous()
    _check(q, k, v, dout.dtype, dout, lse, delta, kernel=name)
    dq = torch.empty_like(q)
    tensors = (q, k, v, dout, lse, delta)
    if name.endswith("_sm90"):
        tensors += (_amax_arg(name, q, dout, dout_amax),)
    _run(name, tensors + (dq,), q, k, scale, causal, dout.dtype)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, scale, causal, variant=None,
              dout_amax=None):
    """Key and value gradients: dk, dv [B, S, H_kv, D] in k's dtype. On the
    sm90 route with bf16 or fp16 q, p and ds are rounded to q's dtype before
    their products and the kernel splits an fp32 dO into two terms of q's
    dtype; on fp16 it scales dO by ``dout_scale`` first (see
    ``flash_dkv_plain``). ``dout_amax`` as for ``flash_dq``. With fp32 q
    every operand stays fp32 (3xTF32)."""
    name = _kernel("flash_dkv", q, variant, dout.dtype)
    rounds = _rounds_operands(name, q, dout.dtype)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, scale, causal,
                               split_dout=rounds, round_operands=rounds)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    if d != dp:
        padded = (pad_head_dim(t, dp) for t in (q, k, v, dout))
        dk, dv = flash_dkv(*padded, lse, delta, scale, causal, variant,
                           dout_amax)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    _check(q, k, v, dout.dtype, dout, lse, delta, kernel=name)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, dout, lse, delta)
    if name.endswith("_sm90"):
        tensors += (_amax_arg(name, q, dout, dout_amax),)
    _run(name, tensors + (dk, dv), q, k, scale, causal, dout.dtype)
    return dk, dv


def wgmma_probe(a, b):
    """One 64 x 64 x 64 product on the tensor cores through the building
    blocks of the sm90 kernels (TMA, wgmma descriptors, the register A
    operand) for [64, 64] CUDA tensors a, b of one dtype: returns
    (a @ b^T, r(a @ b^T) @ b) in fp32, where r rounds to bf16 or fp16 for
    bf16 or fp16 inputs (wgmma's .bf16 or .f16 operands) and is the
    identity for fp32 ones, whose products run as 3xTF32 (split, transposed
    B tile, hi and lo register operands). A check for the card tests; not
    on any path."""
    if a.shape != (64, 64) or b.shape != (64, 64) or a.device.type != "cuda" \
            or a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError("wgmma_probe takes bf16, fp16 or fp32 [64, 64] CUDA "
                         "tensors of one dtype")
    a, b = a.contiguous(), b.contiguous()
    c1 = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    c2 = torch.empty_like(c1)
    lib = _lib("flash_fwd_sm90")
    with torch.cuda.device(a.device):
        rc = lib.hvt_wgmma_probe(a.data_ptr(), b.data_ptr(), c1.data_ptr(),
                                 c2.data_ptr(), _DTYPE_CODE[a.dtype],
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wgmma probe launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    return c1, c2


def wgmma_probe_wide(a, b, w=None):
    """The wide heads' products through the building blocks of the sm90
    kernels. For bf16 CUDA tensors a, b [64, 64] and w [64, n], n 192 or
    256, whose MN-major tile spans n / 64 panels: returns (c1, c2, c3) =
    (a @ b^T, r(c1) @ w, a @ w) in fp32, r rounding to bf16, c2 with the
    register A operand (m64nNk16 as P V, dS K take it), c3 with A from
    shared memory (as the wide dK, dV products). For fp32 CUDA tensors a
    [64, n] and b [r, n], r 16 or 32 (no w), the 3xTF32 ones at padded
    widths 192 and 256: (c1, c2, c3) = (a @ b^T, c1 @ b, (c1 @ b)^T), c1
    with a's A fragments split in registers (m64nRk8 over n / 8 k-steps, as
    S = Q K^T and S^T = K Q^T), c2 with c1's fragment as the register A
    operand against b's transposed split (m64nNk8, as P V), c3 with c1
    written as K-major B tiles and b's split tiles read transposed as A
    (m64n64k8, as dQ^T, dV^T and dK^T). A check for the card tests; not on
    any path."""
    n = a.shape[-1] if w is None else w.shape[-1]
    if a.dtype == torch.float32:
        r = b.shape[0]
        if a.shape != (64, n) or b.shape not in ((16, n), (32, n)) or \
                n not in (192, 256) or w is not None or \
                a.device.type != "cuda" or b.dtype != torch.float32:
            raise ValueError("wgmma_probe_wide takes fp32 CUDA tensors a "
                             "[64, n] and b [16 or 32, n], n 192 or 256")
        a, b = a.contiguous(), b.contiguous()
        outs = [torch.empty(shape, dtype=torch.float32, device=a.device)
                for shape in ((64, r), (64, n), (n, 64))]
        lib = _lib("flash_fwd_sm90")
        with torch.cuda.device(a.device):
            rc = lib.hvt_wgmma_probe_wide_tf32(
                a.data_ptr(), b.data_ptr(), *[c.data_ptr() for c in outs],
                n, r, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"wide tf32 wgmma probe launch failed: "
                               f"{lib.hvt_cuda_error_string(rc).decode()}")
        return tuple(outs)
    if a.shape != (64, 64) or b.shape != (64, 64) or w is None or \
            w.shape not in ((64, 192), (64, 256)) or a.device.type != "cuda" \
            or any(t.dtype != torch.bfloat16 for t in (a, b, w)):
        raise ValueError("wgmma_probe_wide takes bf16 CUDA tensors a, b "
                         "[64, 64] and w [64, 192 or 256]")
    a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
    c1 = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    c2 = torch.empty((64, n), dtype=torch.float32, device=a.device)
    c3 = torch.empty_like(c2)
    lib = _lib("flash_fwd_sm90")
    with torch.cuda.device(a.device):
        rc = lib.hvt_wgmma_probe_wide(
            a.data_ptr(), b.data_ptr(), w.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), c3.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide wgmma probe launch failed: "
                           f"{lib.hvt_cuda_error_string(rc).decode()}")
    return c1, c2, c3
