#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on a failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the six flash-attention kernels from csrc/ with nvcc,
   one process per source, in parallel.
3. kernels: hold every kernel against its plain PyTorch version, and the
   autograd Function built on them against autograd of
   flash_attention_reference, at seven shapes: the main path's (B 8, H 12,
   S 1024, D 64, bf16, causal), non-causal, GQA (H 12, H_kv 4), ragged
   (S 1000, D 32, fp32), bf16 ragged (S 1000, D 64), bf16 GQA at D 128
   (B 2, S 2048, H 8, H_kv 2) and bf16 D 32. bf16 at D 64 and 128 routes
   fwd, dq and dkv to the tensor-core (sm90) kernels, fp32 and D 32 to the
   SIMT ones; at the main shape both designs run. The sm90 dq and dkv are
   also held against the plain versions that keep their operands in fp32,
   as the TPU kernels do, and a second launch of dq on the same inputs
   must give the same bits. At the main shape, time each
   kernel, its plain version and the PyTorch library call that computes the
   same attention (scaled_dot_product_attention, timed only as a
   yardstick), beside the kernel's bound on an H100.
4. main path: hvt.init() (a one-process NCCL world), then
   horovod_tpu_torch.train.train on the bench.py GPT (vocab 32768, 12
   layers, d_model 768, 12 heads, d_ff 3072, seq 1024, bf16, flash
   attention) under DistributedOptimizer(AdamW(lr 1e-4, weight decay
   1e-4)): 2 warm-up and 5 timed steps on one seeded batch of 8 x 1024
   tokens. Losses must be finite and fall; flash_fwd_sm90, flash_dq_sm90
   and flash_dkv_sm90 must launch exactly 12 times a step and the SIMT
   flash_fwd, flash_dq and flash_dkv never. The einsum-attention model from
   the same seed, trained the same 7 steps, must give the same first and
   last loss within 1e-2 (relative; about 2.5 bf16 epsilons): the last one
   catches a wrong dq, dk or dv.
5. profile: two more steps under torch.profiler; device time per step by
   kernel category, each flash kernel's time per launch inside the step,
   and the share of the window in which no kernel ran.
6. summary: one JSON line listing the kernels, the nvidia-smi line, and
   last the {"ok": true, ...} line.
"""

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the least time the card could
# take for a kernel's work is max(bytes / HBM rate, FLOPs / peak rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

CSRC = "horovod_tpu_torch/csrc/"
SOURCE = {"flash_fwd_sm90": CSRC + "flash_fwd_sm90.cu",
          "flash_dq_sm90": CSRC + "flash_dq_sm90.cu",
          "flash_dkv_sm90": CSRC + "flash_dkv_sm90.cu",
          "flash_fwd": CSRC + "flash_fwd.cu",
          "flash_dq": CSRC + "flash_dq.cu",
          "flash_dkv": CSRC + "flash_dkv.cu"}
REPLACES = {"flash_fwd_sm90": "horovod_tpu/ops/flash_attention.py:94",
            "flash_dq_sm90": "horovod_tpu/ops/flash_attention.py:156",
            "flash_dkv_sm90": "horovod_tpu/ops/flash_attention.py:210",
            "flash_fwd": "horovod_tpu/ops/flash_attention.py:94",
            "flash_dq": "horovod_tpu/ops/flash_attention.py:156",
            "flash_dkv": "horovod_tpu/ops/flash_attention.py:210"}
# (B, S, H, H_kv, D, dtype name, causal); the first is the main path's
MAIN_SHAPE = (8, 1024, 12, 12, 64, "bfloat16", True)
CASES = [MAIN_SHAPE,
         (8, 1024, 12, 12, 64, "bfloat16", False),
         (8, 1024, 12, 4, 64, "bfloat16", True),
         (2, 1000, 4, 4, 32, "float32", True),
         (2, 1000, 4, 4, 64, "bfloat16", True),
         (2, 2048, 8, 2, 128, "bfloat16", True),
         (4, 1024, 8, 8, 32, "bfloat16", True)]
# kernel vs its plain version: the same arithmetic, summed in another
# order; bf16 outputs may differ by about one bf16 ulp (2^-8 relative).
TOL_PLAIN = {"float32": 1e-4, "bfloat16": 2e-2}
# flash_dkv_sm90 rounds p and ds to bf16 before p^T dO and ds^T q, where
# flash_dkv and the TPU kernel keep them fp32. Against that fp32-operand
# plain version it is held to the same 2e-2: on the card the least
# tolerance that holds was at most 0.010 over the bf16 cases (about one
# bf16 ulp of dk and dv; PERF.md), so 2e-2 keeps a factor of two.
TOL_DKV_FP32_OPERANDS = 2e-2
# flash_dq_sm90 rounds ds (and an fp32 dO) to bf16 before ds k, where
# flash_dq and the TPU kernel keep ds fp32. On the card the least tolerance
# that holds against that fp32-operand plain version was at most 0.0069
# over the bf16 cases (PERF.md), so 1.4e-2 keeps a factor of two.
TOL_DQ_FP32_OPERANDS = 1.4e-2
# what the sm90 kernels round to bf16, where the TPU kernels keep fp32
ROUNDED = {"flash_dq_sm90": "dO and ds", "flash_dkv_sm90": "p and ds"}
# the autograd Function vs autograd of the dense reference: in bf16 the
# reference's autograd also rounds dp through the p cast, so allow more.
TOL_AUTOGRAD = {"float32": 1e-4, "bfloat16": 5e-2}
STEPS_WARMUP, STEPS_TIMED = 2, 5
PROFILE_STEPS, PROFILE_TOP = 2, 12
LOSS_RTOL = 1e-2
SLEEP_CYCLES = 100_000_000   # about 50 ms of the card's clock


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, warmup=2):
    """(device ms, host ms) per call of ``fn()`` over ``iters`` back-to-back
    calls. Device time by CUDA events; a sleep kernel queued first keeps
    the card busy while the host queues the calls, so a call whose Python
    wrapper takes longer than its kernel is still timed on the device.
    Host time is the queueing alone, without a sync."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def bound(name, b, s, h, h_kv, d, dtype, causal):
    """(bound_ms, bound_by) for one kernel's work at this shape: each input
    read once, each output written once; FLOPs of the visible (q, k) pairs."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes, vec = b * s * h * d * item, b * s * h_kv * d * item, \
        b * h * s * 4
    name = name.replace("_sm90", "")   # both designs do the same work
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[name] * d * pairs
    nbytes = {"flash_fwd": 2 * q_bytes + 2 * kv_bytes + vec,
              "flash_dq": 3 * q_bytes + 2 * kv_bytes + 2 * vec,
              "flash_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * vec}[name]
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output:
    'mangled name: registers; stack and spills', plus any ptxas warning
    that a wgmma product was serialised."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].split(",")[0].strip()
            lines.append(f"{name}: {used}; {spills}")
        elif "C7520" in line or "serialized" in line:
            lines.append(line.strip())
    return lines


def check(tag, got, want, tol):
    """Fail unless |got - want| <= tol (1 + |want|) everywhere. Returns
    (max abs err, max abs err / max |want|, the least tol that holds)."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{tag}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    need = float((diff / (1 + want.float().abs())).max())
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        fail(f"{tag}: max abs err {err:.3g} > tol {tol}: {e}")
    return err, rel, need


def kernel_phase(case, K, ref_fn, timings):
    """Hold the kernels that take this shape against their plain versions
    and autograd of the reference; at the main shape run both designs of
    each kernel, and time every kernel."""
    import torch
    import torch.nn.functional as F

    b, s, h, h_kv, d, dtype_name, causal = case
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
               .to(dtype) for n in (h, h_kv, h_kv))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    scale = d ** -0.5
    tol = TOL_PLAIN[dtype_name]
    shape = {"B": b, "S": s, "H": h, "H_kv": h_kv, "D": d,
             "dtype": dtype_name, "causal": causal}
    main = case == MAIN_SHAPE
    variants = ("sm90", "simt") if main else (K._variant(dtype, d),)

    # both designs get the same inputs: the backward starts from the plain
    # forward's o and lse
    ro, rlse = K.flash_fwd_plain(q, k, v, scale, causal, dtype)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, causal)
    fp32_operands = {"dq": K.flash_dq_plain(*args),
                     **dict(zip(("dk", "dv"), K.flash_dkv_plain(*args)))}
    errs = {}
    for variant in variants:
        sm90 = variant == "sm90"
        fwd, dqn, dkv = (K._kernel(base, q, variant)
                         for base in ("flash_fwd", "flash_dq", "flash_dkv"))
        o, lse = K.flash_fwd(q, k, v, scale, causal, dtype, variant=variant)
        got = {"dq": K.flash_dq(*args, variant=variant),
               **dict(zip(("dk", "dv"), K.flash_dkv(*args, variant=variant)))}
        torch.cuda.synchronize()
        errs[fwd] = [check(f"{fwd} o", o, ro, tol),
                     check(f"{fwd} lse", lse, rlse, 1e-4)]
        if not torch.equal(K.flash_dq(*args, variant=variant), got["dq"]):
            fail(f"{dqn}: a second launch on the same inputs gave other bits")
        want = fp32_operands
        if sm90:    # the plain versions that round where the kernels do
            want = {"dq": K.flash_dq_plain(*args, round_operands=True),
                    **dict(zip(("dk", "dv"), K.flash_dkv_plain(
                        *args, round_operands=True)))}
        for name, outs in ((dqn, ("dq",)), (dkv, ("dk", "dv"))):
            errs[name] = [check(f"{name} {n}", got[n], want[n], tol)
                          for n in outs]
            if not sm90:
                continue
            tol32 = (TOL_DQ_FP32_OPERANDS if name == dqn
                     else TOL_DKV_FP32_OPERANDS)
            vs32 = [check(f"{name} {n} vs fp32 operands", got[n],
                          fp32_operands[n], tol32) for n in outs]
            emit({"phase": "kernel", "kernel": name, "shape": shape,
                  "vs": f"plain version with fp32 {ROUNDED[name]} operands",
                  "max_abs_err": max(e[0] for e in vs32),
                  "max_rel_err": max(e[1] for e in vs32),
                  "least_tol": max(e[2] for e in vs32), "tol": tol32})
        del o, lse, got, want
    for name, found in errs.items():
        emit({"phase": "kernel", "kernel": name, "shape": shape,
              "vs": "plain version" + (f" with bf16 {ROUNDED[name]} operands"
                                       if name in ROUNDED else ""),
              "max_abs_err": max(e[0] for e in found),
              "max_rel_err": max(e[1] for e in found),
              "least_tol": max(e[2] for e in found), "tol": tol})

    # end to end through autograd: kernels vs autograd of the reference
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    tol_ag = TOL_AUTOGRAD[dtype_name]
    grads = {}
    for label, fn in (("kernels", flash_attention_with_lse),
                      ("reference", ref_fn)):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out, _ = fn(*leaves, causal=causal, scale=scale)
        out.backward(do)
        grads[label] = [out.detach()] + [x.grad for x in leaves]
    ag = [check(f"autograd {n}", a, r, tol_ag) for n, a, r in
          zip(("o", "dq", "dk", "dv"), grads["kernels"], grads["reference"])]
    emit({"phase": "autograd", "shape": shape,
          "vs": "autograd of flash_attention_reference",
          "max_abs_err": max(e[0] for e in ag),
          "max_rel_err": max(e[1] for e in ag), "tol": tol_ag})
    del grads

    if not main:
        return
    # SDPA takes [B, H, S, D]; its K/V carry the full head count
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(h // h_kv, 2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(h // h_kv, 2).transpose(1, 2).contiguous()
    doh = do.transpose(1, 2).contiguous()
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, scale=scale), 20)[0]
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             scale=scale)
        torch.autograd.grad(out, leaves, doh)

    sdpa_pair = cuda_ms(sdpa_fwd_bwd, 20)[0]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         scale=scale)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, doh,
                                                   retain_graph=True), 20)[0]
    del out
    timed = {}
    for variant in variants:
        sm90 = variant == "sm90"
        timed[K._kernel("flash_fwd", q, variant)] = (
            lambda vr=variant: K.flash_fwd(q, k, v, scale, causal, dtype,
                                           variant=vr),
            lambda: K.flash_fwd_plain(q, k, v, scale, causal, dtype),
            sdpa_fwd)
        timed[K._kernel("flash_dq", q, variant)] = (
            lambda vr=variant: K.flash_dq(*args, variant=vr),
            lambda r=sm90: K.flash_dq_plain(*args, round_operands=r),
            sdpa_pair)
        timed[K._kernel("flash_dkv", q, variant)] = (
            lambda vr=variant: K.flash_dkv(*args, variant=vr),
            lambda r=sm90: K.flash_dkv_plain(*args, round_operands=r),
            sdpa_pair)
    for name, (kern, plain, lib) in timed.items():
        bound_ms, bound_by = bound(name, b, s, h, h_kv, d, dtype_name,
                                   causal)
        ms, host_ms = cuda_ms(kern, 20)
        timings[name] = {"max_abs_err": max(e[0] for e in errs[name]),
                         "ms": ms, "plain_ms": cuda_ms(plain, 5)[0],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib}
        emit({"phase": "timing", "kernel": name, "shape": shape,
              **timings[name], "wrapper_host_ms": host_ms,
              "library": "scaled_dot_product_attention "
                         + ("forward" if name.startswith("flash_fwd")
                            else "forward + backward"),
              "library_backward_only_ms": sdpa_bwd})


def main_path(hvt, K):
    """The port's GPT training step at full width, through the entry point
    a user calls (``horovod_tpu_torch.train.train``). Returns the launch
    count of each kernel and the trained model and optimizer."""
    import dataclasses

    import torch

    from horovod_tpu_torch.train import gpt_config, train

    hvt.init()                  # a one-process NCCL world on cuda:0
    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    batch, seq, steps = 8, cfg.max_seq_len, STEPS_WARMUP + STEPS_TIMED

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = train(cfg, steps, batch, seq, seed=0)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = res["loss"]
    per_step = cfg.n_layers
    suffix = "_sm90" if K._variant(cfg.dtype,
                                   cfg.d_model // cfg.n_heads) == "sm90" else ""
    on_path = {base + suffix for base in ("flash_fwd", "flash_dq",
                                          "flash_dkv")}
    for name, n in launches.items():
        want = per_step * steps if name in on_path else 0
        if n != want:
            fail(f"{name} launched {n} times in {steps} steps, expected "
                 f"{want // steps} a step")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on the repeated batch: {losses}")
    step_s = statistics.median(res["step_s"][STEPS_WARMUP:])
    emit({"phase": "main_path", "config": "bench.py --model gpt --flash",
          "batch": batch, "seq": seq, "world_size": hvt.size(),
          "losses": losses, "step_s": res["step_s"][STEPS_WARMUP:],
          "step_ms_median": step_s * 1e3,
          "tokens_per_s": batch * seq / step_s,
          "max_memory_allocated_bytes": peak,
          "launches": launches, "launches_per_step": per_step})

    # the einsum-attention model from the same seed starts from the same
    # weights and sees the same tokens: its losses follow the flash ones.
    # The first loss checks the forward; the last, after 6 AdamW steps on
    # each path's own gradients, checks dq, dk and dv as well.
    before = dict(K.LAUNCHES)
    einsum = train(dataclasses.replace(cfg, use_flash=False), steps, batch,
                   seq, seed=0)
    if dict(K.LAUNCHES) != before:
        fail("the einsum-attention step launched flash kernels")
    rels = [abs(einsum["loss"][i] - losses[i]) / abs(losses[i])
            for i in range(steps)]
    emit({"phase": "einsum_vs_flash", "flash_losses": losses,
          "einsum_losses": einsum["loss"], "rel_diff": rels,
          "rtol": LOSS_RTOL, "einsum_step_ms_median":
          statistics.median(einsum["step_s"][STEPS_WARMUP:]) * 1e3})
    for i in (0, steps - 1):
        if rels[i] > LOSS_RTOL:
            fail(f"step {i + 1}: einsum loss {einsum['loss'][i]} vs flash "
                 f"loss {losses[i]}: rel diff {rels[i]:.3g} > {LOSS_RTOL}")
    del einsum
    return launches, res["model"], res["optimizer"], cfg, batch, seq, step_s


# the sm90 names first: _category matches by substring
FLASH_KERNELS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
                 "flash_fwd", "flash_dq", "flash_dkv")


def _category(kernel_name):
    name = kernel_name.lower()
    for flash in FLASH_KERNELS:
        if flash in name:
            return flash
    if "nccl" in name:
        return "nccl"
    if any(t in name for t in ("gemm", "xmma", "cutlass", "cublas",
                               "nvjet")):
        return "matmul"
    return "other"


def profile_phase(model, optimizer, cfg, batch, seq, step_s, launches):
    """Where a main-path step's device time goes: kernel time by category
    under torch.profiler over PROFILE_STEPS steps. Profiling slows the
    host, so the idle share is given twice: of the profiled window, and of
    the unprofiled median step ``step_s`` from the main path phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.train import make_train_step, seeded_tokens

    step = make_train_step(model, optimizer)
    tokens = seeded_tokens(cfg, batch, seq, seed=0)
    step(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            float(step(tokens))     # waits for the device, as train() does
    # device activity: kernels, copies and sets, but not the annotation
    # ranges (e.g. "Optimizer.step#AdamW.step") that overlap them
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        emit({"phase": "profile", "device_time": "not measured",
              "why": "torch.profiler recorded no device events"})
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:                       # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    per_step = {n: launches[n] // (STEPS_WARMUP + STEPS_TIMED)
                for n in FLASH_KERNELS}
    emit({"phase": "profile", "steps": PROFILE_STEPS,
          "in_step_ms_per_launch": {
              n: by_cat[n] / 1e3 / PROFILE_STEPS / per_step[n]
              for n in FLASH_KERNELS if per_step[n] and n in by_cat},
          "device_ms_per_step": {c: t / 1e3 / PROFILE_STEPS
                                 for c, t in sorted(by_cat.items())},
          "busy_ms_per_step": busy / 1e3 / PROFILE_STEPS,
          "window_ms_per_step": window / 1e3 / PROFILE_STEPS,
          "idle_share_of_profiled_window": 1.0 - busy / window,
          "idle_share_of_step": 1.0 - busy / 1e6 / PROFILE_STEPS / step_s,
          "top_kernels_ms_per_step": [[n[:90], t / 1e3 / PROFILE_STEPS]
                                      for n, t in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script drives the "
             "port on a GPU")
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0)})
    # plain versions and references in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = K.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in libs.items()},
          "ptxas": {n: ptxas_summary(log)
                    for n, log in K.build_log().items()}})

    timings = {}
    for case in CASES:
        kernel_phase(case, K, flash_attention_reference, timings)
        torch.cuda.empty_cache()

    launches, *trained = main_path(hvt, K)
    profile_phase(*trained, launches)
    hvt.shutdown()

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **timings[name]} for name in K.LAUNCHES]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
