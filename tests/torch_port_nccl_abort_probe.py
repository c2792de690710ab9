"""How the survivors of a torch.distributed group learn that a peer died,
and what it costs: N processes allreduce in a loop until the last one
SIGKILLs itself; each survivor records the seconds from the kill to the
exception its collective raised, tears its group down and joins a new one
of N-1 processes. Imports no JAX.

    python tests/torch_port_nccl_abort_probe.py DEVICE N MODE OUT [ASYNC]

DEVICE cuda (NCCL, one card a process) or cpu (gloo). MODE abort: each
survivor's watcher thread calls ``_abort_process_group`` as soon as the
death is visible (a file the dying rank writes first, standing in for the
elastic driver's notification). MODE timeout: nobody aborts; the group's
20 s timeout and the backend's own error handling decide. ASYNC sets
``TORCH_NCCL_ASYNC_ERROR_HANDLING``. Each survivor writes ``OUT.<rank>.json``
and the parent prints them.
"""
import json, os, signal, socket, subprocess, sys, threading, time

def child(device, n, mode, out, rank, port, port2):
    import torch, torch.distributed as dist
    res = {"rank": rank, "torch": torch.__version__,
           "has_abort_pg": hasattr(dist.distributed_c10d, "_abort_process_group"),
           "env_async": os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING")}
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    dev = torch.device(device, rank) if device == "cuda" else torch.device("cpu")
    from datetime import timedelta
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank, timeout=timedelta(seconds=20))
    x = torch.ones(1 << 20, device=dev)
    killed = out + ".killed"
    aborted = {}
    if rank != n - 1 and mode == "abort":
        def watch():
            while not os.path.exists(killed):
                time.sleep(0.01)
            t0 = time.time()
            try:
                if hasattr(dist.distributed_c10d, "_abort_process_group"):
                    dist.distributed_c10d._abort_process_group()
                    aborted["how"] = "_abort_process_group"
                else:
                    dist.group.WORLD.abort()
                    aborted["how"] = "WORLD.abort"
            except Exception as e:
                aborted["error"] = repr(e)[:300]
            aborted["abort_s"] = time.time() - t0
            aborted["at"] = time.time()
        threading.Thread(target=watch, daemon=True).start()
    t_exc = None
    i = 0
    try:
        while True:
            i += 1
            if rank == n - 1 and i == 20:
                with open(killed, "w") as f:
                    f.write(str(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            dist.all_reduce(x)
            x.div_(n)
            v = float(x.sum())
            if i > 10000:
                break
    except BaseException as e:
        t_exc = time.time()
        res["exc"] = f"{type(e).__module__}.{type(e).__name__}: {str(e)[:300]}"
        res["exc_mro"] = [c.__name__ for c in type(e).__mro__]
    res["iters"] = i
    with open(killed) as f:
        t_kill = float(f.read())
    res["kill_to_exc_s"] = None if t_exc is None else t_exc - t_kill
    res["aborted"] = aborted
    t0 = time.time()
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
            res["teardown"] = "destroy_process_group"
        else:
            res["teardown"] = "none needed"
    except Exception as e:
        res["teardown_error"] = repr(e)[:300]
    res["teardown_s"] = time.time() - t0
    t0 = time.time()
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port2}",
                                world_size=n - 1, rank=rank,
                                timeout=timedelta(seconds=20))
        y = torch.ones(4, device=dev)
        dist.all_reduce(y)
        res["reinit_value"] = float(y[0])
        dist.destroy_process_group()
    except Exception as e:
        res["reinit_error"] = repr(e)[:300]
    res["reinit_s"] = time.time() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0)); return s.getsockname()[1]

if __name__ == "__main__":
    if sys.argv[1] == "child":
        device, n, mode, out, rank, port, port2 = sys.argv[2:]
        child(device, int(n), mode, out, int(rank), int(port), int(port2))
        sys.exit(0)
    device, n, mode, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    p1, p2 = free_port(), free_port()
    env = dict(os.environ)
    if len(sys.argv) > 5:
        env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = sys.argv[5]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, "child", device, str(n), mode, out,
                               str(r), str(p1), str(p2)], env=env) for r in range(n)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=150))
        except subprocess.TimeoutExpired:
            p.kill(); rcs.append("hung")
    print(json.dumps({"device": device, "mode": mode, "async_env": env.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"), "rcs": rcs, "seconds": time.time() - t0}))
    for r in range(n - 1):
        try:
            print(open(f"{out}.{r}.json").read())
        except OSError as e:
            print("no result", r, e)
