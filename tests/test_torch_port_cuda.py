"""horovod_tpu_torch's Hopper kernels on the card, held against their plain
PyTorch versions. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is missing; the
repo's conftest imports JAX, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 1e-5 (the same fp32 arithmetic summed in another order);
bf16 2e-2, about two bf16 ulps at the outputs' magnitude. The sm90 dq and
dkv kernels are held to the plain versions that round dO, p and ds to bf16
where the tensor cores take them (``round_operands=True``).
"""

import pytest
import torch

from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                   flash_attention_with_lse)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

# (B, S, H, H_kv, D, dtype, causal, out_dtype)
CASES = [
    (2, 100, 4, 2, 32, torch.float32, True, torch.float32),      # ragged, GQA
    (2, 256, 4, 4, 64, torch.bfloat16, False, torch.bfloat16),
    (1, 300, 4, 1, 128, torch.bfloat16, True, torch.bfloat16),   # MQA, D 128
    (2, 130, 2, 2, 8, torch.float32, False, torch.float32),      # smallest D
    (2, 192, 4, 2, 64, torch.bfloat16, True, torch.float32),     # fp32 o
    (2, 100, 4, 2, 64, torch.bfloat16, True, torch.bfloat16),    # ragged, GQA
]
# every case on the SIMT kernels; the bf16 D 64/128 cases also on sm90
VARIANT_CASES = [(c, "simt") for c in CASES] + [
    (c, "sm90") for c in CASES
    if _kernels._variant(c[5], c[4]) == "sm90"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device):
    b, s, h, h_kv, d, dtype, _, out_dtype = case
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=device).to(dtype)
               for n in (h, h_kv, h_kv))
    do = torch.randn(b, s, h, d, generator=gen, device=device).to(out_dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case,variant", VARIANT_CASES,
                         ids=lambda c: "-".join(map(str, c[:5]))
                         if isinstance(c, tuple) else c)
def test_kernels_match_plain_versions(cuda, case, variant):
    q, k, v, do = _inputs(case, cuda)
    causal, out_dtype, tol = case[6], case[7], TOL[case[5]]
    scale = q.shape[-1] ** -0.5
    before = dict(_kernels.LAUNCHES)
    o, lse = _kernels.flash_fwd(q, k, v, scale, causal, out_dtype,
                                variant=variant)
    ro, rl = _kernels.flash_fwd_plain(q, k, v, scale, causal, out_dtype)
    assert o.dtype == out_dtype
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-5)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, scale, causal)
    sm90 = variant == "sm90"
    dq = _kernels.flash_dq(*args, variant=variant)
    assert dq.dtype == q.dtype
    torch.testing.assert_close(
        dq.float(),
        _kernels.flash_dq_plain(*args, round_operands=sm90).float(),
        rtol=tol, atol=tol)
    for got, want in zip(_kernels.flash_dkv(*args, variant=variant),
                         _kernels.flash_dkv_plain(*args,
                                                  round_operands=sm90)):
        assert got.shape == k.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    suffix = "_sm90" if sm90 else ""
    want_launches = {n: 0 for n in before}
    want_launches.update({"flash_fwd" + suffix: 1, "flash_dq" + suffix: 1,
                          "flash_dkv" + suffix: 1})
    assert {n: _kernels.LAUNCHES[n] - before[n] for n in before} == \
        want_launches


@pytest.mark.cuda
def test_single_wgmma_product_matches_matmul(cuda):
    """The sm90 kernels' building blocks on one 64 x 64 x 64 product: TMA
    into 128-byte-swizzled tiles, K-major and MN-major descriptors, and an
    accumulator reused as the bf16 register A operand. bf16 products are
    exact in fp32, so only the order of the fp32 sums differs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(64, 64, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    c1, c2 = _kernels.wgmma_probe(a, b)
    torch.testing.assert_close(c1, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(c2, c1.to(torch.bfloat16).float() @ b.float(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_autograd_function_matches_autograd_of_reference(cuda):
    """Gradients through o and lse, as a ring-attention combine needs."""
    q, k, v, do = _inputs((2, 200, 4, 2, 32, torch.float32, True,
                           torch.float32), cuda)
    w = torch.randn(2, 200, 4, device=cuda)
    grads = []
    for fn in (flash_attention_with_lse, flash_attention_reference):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*leaves, causal=True)
        ((o * do).sum() + (lse * w).sum()).backward()
        grads.append([o.detach(), lse.detach()] + [x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 16, 2, 12, device=cuda)          # D % 8 != 0
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(q, q, q, 1.0, True, torch.float32)
    q = torch.zeros(1, 16, 2, 256, device=cuda)         # D > 128
    with pytest.raises(ValueError, match="head_dim"):
        _kernels.flash_fwd(q, q, q, 1.0, True, torch.float32)
    q = torch.zeros(1, 16, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        _kernels.flash_fwd(q, q, q, 1.0, True, torch.float16)


DP_WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.train import gpt_config, train

device, steps, batch, out = json.loads(sys.argv[1])
cfg = gpt_config("entry", dtype=torch.float32, use_flash=True)
torch.backends.cuda.matmul.allow_tf32 = False
res = train(cfg, steps, batch, 32, device=device, lr=1e-3)
if hvt.rank() == 0:
    torch.save({k: v.cpu() for k, v in res["model"].state_dict().items()},
               out + ".pt")
with open(out + f".{hvt.rank()}.json", "w") as f:
    json.dump({"rank": hvt.rank(), "size": hvt.size(),
               "device": str(hvt.device()), "loss": res["loss"]}, f)
hvt.shutdown()
"""


def run_dp_gang(n, device, steps, batch, out):
    """Start ``n`` processes of DP_WORKER through the hvtrun identity env;
    return (per-rank results, rank 0's final state_dict)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=repo, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES=str(n), HVT_LOCAL_PROCESS_ID=str(r),
                   HVT_LOCAL_SIZE=str(n), HVT_CROSS_RANK="0",
                   HVT_CROSS_SIZE="1",
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DP_WORKER,
             json.dumps([device, steps, batch, out])], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = []
    for r in range(n):
        with open(f"{out}.{r}.json") as f:
            results.append(json.load(f))
    return results, torch.load(out + ".pt")


@pytest.mark.cuda
def test_nccl_dp_step_equals_the_one_process_step(cuda, tmp_path):
    """Each of n ranks (one per card, NCCL) takes a slice of the global
    batch; the averaged gradients make the same two AdamW steps as one
    process on the whole batch. Tolerances as in test_torch_port_train.py."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.train import gpt_config, train

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    steps, batch = 2, 2
    results, dp_state = run_dp_gang(n, "cuda", steps, batch,
                                    str(tmp_path / "dp"))
    assert [r["rank"] for r in results] == list(range(n))
    assert [r["device"] for r in results] == [f"cuda:{r}" for r in range(n)]
    try:
        one = train(gpt_config("entry", dtype=torch.float32, use_flash=True),
                    steps, n * batch, 32, lr=1e-3)
    finally:
        basics.shutdown()
    dp_loss = torch.tensor([r["loss"] for r in results]).mean(0)
    torch.testing.assert_close(dp_loss, torch.tensor(one["loss"]),
                               rtol=1e-4, atol=1e-5)
    for name, want in one["model"].state_dict().items():
        torch.testing.assert_close(dp_state[name], want.cpu(), rtol=1e-3,
                                   atol=1e-4, msg=name)
