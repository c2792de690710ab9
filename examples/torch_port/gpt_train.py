"""GPT training on the port's mesh, data × tensor × sequence parallel (the
JAX package's ``examples/jax/jax_gpt_train.py``): the batch's rows split
over ``dp``, its columns over ``sp`` (ring attention), the Megatron
shards of each layer and the vocabulary over ``tp``. One process a rank:

    python -m horovod_tpu_torch.runner.launch -np 8 \\
        python examples/torch_port/gpt_train.py --dp 2 --tp 2 --sp 2

Runs on the card of each process's local rank; ``--device cpu`` runs on
gloo in fp32 with the einsum attention.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
from horovod_tpu_torch.train import make_parallel_train_step


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    hvt.init(device=args.device)
    cuda = hvt.device().type == "cuda"
    mesh = make_parallel_mesh(dp=args.dp, sp=args.sp, tp=args.tp)
    cfg = GPTConfig(vocab_size=args.vocab, n_layers=args.layers,
                    d_model=args.d_model, n_heads=args.heads,
                    d_ff=4 * args.d_model, max_seq_len=args.seq,
                    dtype=torch.bfloat16 if cuda else torch.float32,
                    use_flash="auto" if cuda else False,
                    ring_mesh=mesh if args.sp > 1 else None)
    model = GPT(cfg, device=hvt.device(), seed=0, mesh=mesh)
    step = make_parallel_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=3e-4), mesh)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (args.batch, args.seq))).to(hvt.device())
    for i in range(args.steps):
        loss = float(step(tokens))
        if hvt.rank() == 0:
            print(f"step {i}: loss {loss:.4f}", flush=True)
    assert np.isfinite(loss), "training diverged"
    hvt.shutdown()


if __name__ == "__main__":
    main()
