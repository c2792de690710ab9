"""horovod_tpu_torch.ops.losses.softmax_cross_entropy_fused against the JAX
package's (horovod_tpu/ops/losses.py), value and gradients, on the same
numpy inputs; and the port's GPT(return_hidden=True) with the chunked loss
against its own unchunked loss (train.loss_fn).

Sequences are not a chunk multiple, so the last chunk is short (the JAX side
pads and masks it). Tolerances: fp32 rtol 1e-5 / atol 1e-6 (one fp32
computation summed in another order); from bf16 hidden states the loss is
fp32 on both sides (rtol 1e-5) and the hidden gradient is rounded to bf16
on both, so it may differ by one bf16 ulp (rtol 1e-2, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.losses import softmax_cross_entropy_fused as jax_ce
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.ops.losses import softmax_cross_entropy_fused
from horovod_tpu_torch.train import loss_fn

B, S, D, V = 2, 45, 16, 64


def _inputs(seed):
    rs = np.random.RandomState(seed)
    hidden = rs.normal(size=(B, S, D)).astype(np.float32)
    emb = (rs.normal(size=(V, D)) * 0.3).astype(np.float32)
    targets = rs.randint(0, V, (B, S)).astype(np.int32)
    return hidden, emb, targets


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 128])
def test_chunked_ce_matches_jax(dtype, chunk):
    hidden, emb, targets = _inputs(0)
    jh = jnp.asarray(hidden, getattr(jnp, dtype))
    loss, (gh, ge) = jax.value_and_grad(jax_ce, argnums=(0, 1))(
        jh, jnp.asarray(emb), jnp.asarray(targets), chunk=chunk)

    th = torch.from_numpy(hidden).to(getattr(torch, dtype)).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    got = softmax_cross_entropy_fused(th, te, torch.from_numpy(targets),
                                      chunk=chunk)
    got.backward()
    assert th.grad.dtype == th.dtype
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-5))
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(gh.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), rtol=1e-5,
                               atol=1e-6)


def test_chunk_must_be_positive():
    hidden, emb, targets = _inputs(1)
    with pytest.raises(ValueError, match="chunk"):
        softmax_cross_entropy_fused(torch.from_numpy(hidden),
                                    torch.from_numpy(emb),
                                    torch.from_numpy(targets), chunk=0)


def test_gpt_chunked_loss_matches_its_unchunked_loss():
    """The port's GPT: the chunked loss from the hidden states equals the
    cross-entropy of the full logits, and so do the gradients of every
    parameter (fp32; seq 40, 39 targets a row: not a multiple of the
    chunk)."""
    cfg = GPTConfig(vocab_size=64, n_layers=2, d_model=32, n_heads=2,
                    d_ff=64, max_seq_len=64, dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, 64, (2, 40)))
    grads = []
    losses = []
    for chunked in (False, True):
        model = GPT(cfg, device="cpu", seed=0)
        loss = loss_fn(model, tokens, chunked_ce=chunked)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for name, want in grads[0].items():
        torch.testing.assert_close(grads[1][name], want, rtol=1e-4,
                                   atol=1e-6, msg=name)
