"""The port's observability gangs (no JAX): ``python -m
horovod_tpu_torch.runner.launch -np 2 [--metrics-port P] [--timeline T]
python tests/torch_port_observe_worker.py MODE OUT``.

- ``metrics``: run :func:`dispatch_sequence` on gloo, then scrape every
  rank's ``GET /metrics`` (base port + rank) and write ``OUT.<rank>.json``
  with this rank's JSON snapshot and the scraped texts.
- ``timeline``: run a few collectives, sync and async, named and not,
  under the launcher's ``--timeline``, and shut down (which uploads the
  shard).

:func:`dispatch_sequence` imports neither package, so the tests run the
same calls on the JAX package.
"""

import json
import os
import sys
import urllib.request

import numpy as np


def dispatch_sequence(hvt, T):
    """One call of each eager collective, sync forms only (the JAX package
    counts those), on small numpy inputs turned into tensors by ``T``,
    whose shapes divide by a world of 1, 2 or 4."""
    hvt.allreduce(T(np.ones((4,), np.float32)), name="x")
    hvt.allreduce(T(np.ones((2, 3), np.float64)), op=hvt.Sum, name="y")
    hvt.grouped_allreduce([T(np.ones(3, np.float32)),
                           T(np.ones(5, np.float32))], name="gg")
    hvt.allgather(T(np.ones((2, 3), np.float32)), name="ag")
    hvt.broadcast(T(np.ones(7, np.int32)), root_rank=0, name="b")
    hvt.alltoall(T(np.ones((4, 2), np.float32)), name="aa")
    hvt.reducescatter(T(np.ones((4, 2), np.float32)), name="rs")
    hvt.barrier()
    hvt.join()


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def main(mode, out):
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import metrics

    hvt.init(device="cpu")
    r = hvt.rank()
    res = {"env": {k: v for k, v in os.environ.items()
                   if k.startswith("HVT_")}}
    if mode == "metrics":
        dispatch_sequence(hvt, torch.from_numpy)
        res["snapshot"] = metrics.json_snapshot()
        res["port"] = metrics.server_port()
        hvt.barrier()          # every rank's endpoint is up and fed
        base = int(os.environ["HVT_METRICS_PORT"])
        res["scraped"] = [_scrape(base + peer) for peer in range(hvt.size())]
        hvt.barrier()          # nobody stops serving before the others read
    else:
        x = torch.full((4,), float(r + 1))
        hvt.allreduce(x, name="grad/w")
        h = hvt.allreduce_async(x, op=hvt.Sum)
        hvt.allgather(torch.ones(r + 1, 2), name="rows")
        hvt.synchronize(h)
        hvt.barrier()
        res["diagnostics"] = hvt.diagnostics()
    with open(f"{out}.{r}.json", "w") as f:
        json.dump(res, f)
    hvt.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
