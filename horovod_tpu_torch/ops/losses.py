"""Memory-bounded language-model loss, ported from
``horovod_tpu/ops/losses.py`` (``softmax_cross_entropy_fused``).

The mean token cross-entropy of ``hidden @ emb.T`` is taken over sequence
chunks, so at most one chunk's fp32 logits ``[B, chunk, V]`` exist at a time,
in the forward and in the backward, which recomputes each chunk's logits
from ``hidden`` and ``emb`` and the log-sum-exp kept from the forward
(``[B, S]`` fp32). At vocab 32768, seq 1024 and batch 8 the whole logits
are 1 GiB of fp32; a chunk of 128 is 128 MiB.

The JAX function pads the sequence to a chunk multiple and masks the
padding, because its ``lax.scan`` needs chunks of one shape; here the last
chunk is shorter instead, which sums the same terms. The chunk products
are ``torch.matmul`` in fp32, as the JAX function leaves them to XLA.
"""

from __future__ import annotations

import torch


def _chunks(s, chunk):
    return [slice(i, min(i + chunk, s)) for i in range(0, s, chunk)]


class _FusedCrossEntropy(torch.autograd.Function):
    """(hidden [B, S, D], emb [V, D], targets [B, S]) → the mean loss."""

    @staticmethod
    def forward(ctx, hidden, emb, targets, chunk):
        b, s, _ = hidden.shape
        w = emb.float()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lse = torch.empty((b, s), dtype=torch.float32, device=hidden.device)
        for c in _chunks(s, chunk):
            logits = torch.matmul(hidden[:, c].float(), w.t())
            lse[:, c] = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, targets[:, c, None])[..., 0]
            total += (lse[:, c] - picked).sum()
        ctx.save_for_backward(hidden, emb, targets, lse)
        ctx.chunk = chunk
        return total / (b * s)

    @staticmethod
    def backward(ctx, grad):
        hidden, emb, targets, lse = ctx.saved_tensors
        b, s, d = hidden.shape
        w = emb.float()
        scale = grad / (b * s)
        dh = torch.empty(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        demb = torch.zeros_like(w)
        for c in _chunks(s, ctx.chunk):
            h = hidden[:, c].float()
            # d loss / d logits = (softmax - onehot(target)) · scale
            dlogits = torch.exp(torch.matmul(h, w.t()) - lse[:, c, None])
            t = targets[:, c, None]
            dlogits.scatter_add_(-1, t, torch.full(t.shape, -1.0,
                                                   device=t.device))
            dlogits *= scale
            dh[:, c] = torch.matmul(dlogits, w)
            demb.addmm_(dlogits.reshape(-1, w.shape[0]).t(), h.reshape(-1, d))
        return dh.to(hidden.dtype), demb.to(emb.dtype), None, None


def softmax_cross_entropy_fused(hidden, emb, targets, *, chunk=128):
    """Mean token cross-entropy of ``hidden @ emb.T`` against ``targets``.

    ``hidden`` [batch, seq, d_model] (any float dtype; the projection is
    fp32), ``emb`` [vocab, d_model] (the tied embedding), ``targets``
    [batch, seq] int ids. Peak logits memory is [batch, chunk, vocab] in the
    forward and the backward. Returns the scalar mean over every token;
    differentiable in ``hidden`` and ``emb``, with the gradients of the
    unchunked loss."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _FusedCrossEntropy.apply(hidden, emb, targets.long(),
                                    min(chunk, hidden.shape[1]))
