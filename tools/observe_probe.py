"""Two measurements of the observability plane's cost and side effects on
one or four GPUs, each holding this tree against another checkout of the
port (e.g. the parent commit, unpacked with ``git archive``).

``python tools/observe_probe.py compare --parent DIR [--out DIR]``
    One card. Four processes in turns (parent, this tree, this tree,
    parent), each timing the main path's GPT step (``train.train``,
    ``bench.py --model gpt --flash`` at full width). The first process of
    each tree then profiles the step replayed from a CUDA graph in many
    windows of two replays, after one of these preludes, in turns: three
    eager steps alone (``none``), inside a ``torch.profiler`` session
    (``torch_profiler``), or, in a tree that has it, inside
    ``hvt.start_timeline(profiler=True)`` (``timeline``). A replay launches
    the same kernels every time, so a window whose profile holds fewer
    kernel records than the others shows records that the profiler lost.

``python tools/observe_probe.py run --root . --result R.json --drops
--warmup-windows``
    The same in one process of one tree, every other window after one
    replay that the profiler's schedule traces and discards.

``python tools/observe_probe.py compare4 --parent DIR [--out DIR]``
    Four cards. The port's launcher runs ``-np 4`` of the main path's GPT
    step (``DistributedOptimizer(AdamW)``, 8 rows a card) for each tree in
    turns (parent, this tree, this tree, parent).

Each prints one JSON line a process or a job, and a summary line last;
the details go to ``--out`` (default ``chiprun_out/observe_probe``).
Needs CUDA; imports the port of the tree given to each process.
"""

import argparse
import collections
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WARMUP = 2


def _import_port(root):
    sys.path.insert(0, os.path.abspath(root))
    import horovod_tpu_torch as hvt

    where = os.path.dirname(os.path.dirname(os.path.abspath(hvt.__file__)))
    if where != os.path.abspath(root):
        raise SystemExit(f"imported the port from {where}, not {root}")
    return hvt


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _setup(a):
    """The port of ``a.root``, initialised, and the GPT configuration."""
    hvt = _import_port(a.root)
    import torch

    from horovod_tpu_torch.train import gpt_config

    hvt.init(device=a.device)
    dtype = torch.bfloat16 if a.device == "cuda" else torch.float32
    return hvt, gpt_config(a.config, use_flash=a.device == "cuda",
                           dtype=dtype)


def _step_ms(a, cfg):
    from horovod_tpu_torch.train import train

    res = train(cfg, WARMUP + a.steps, a.batch, cfg.max_seq_len,
                device=a.device, seed=0)
    ms = [s * 1e3 for s in res["step_s"][WARMUP:]]
    return {"step_ms_median": statistics.median(ms), "step_ms": ms,
            "losses": res["loss"]}


def _device_names(prof):
    """Names of the device records of a torch.profiler session, in device
    order."""
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.time_range.start)
    return [e.name for e in kernels]


def _window(replay, replays, warmup):
    """Device record names of ``replays`` replays profiled in one
    torch.profiler session, after ``warmup`` replays that the profiler's
    schedule traces and discards."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=warmup, active=replays, repeat=1) \
        if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for _ in range(replays + warmup):
            float(replay())
            if warmup:
                prof.step()
    return _device_names(prof)


def _flash(names):
    return sum("flash_fwd_sm90" in n for n in names)


def _prelude(arm, hvt, cfg, batch, path):
    """Three eager steps of a fresh model, alone or inside a profiler
    session that is stopped and exported. Returns the session's count of
    flash_fwd_sm90 records, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.train import train

    def steps():
        train(cfg, 3, batch, cfg.max_seq_len, seed=0)

    flash = None
    if arm == "none":
        steps()
    elif arm == "torch_profiler":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps()
        prof.export_chrome_trace(path + ".profiler.json")
        flash = _flash(_device_names(prof))
    else:
        hvt.start_timeline(path, profiler=True)
        steps()
        hvt.stop_timeline()
        with open(path + ".profiler.json") as f:
            flash = _flash(e.get("name", "") for e in
                           json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return flash


def _drops(hvt, cfg, a):
    import torch

    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import make_train_step, seeded_tokens

    arms = ["none", "torch_profiler"]
    if hasattr(hvt, "start_timeline"):
        arms.append("timeline")
    model = GPT(cfg, device=hvt.device(), seed=0)
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, capturable=True))
    step = make_train_step(model, opt)
    replay = bench.capture_step(
        step, seeded_tokens(cfg, a.batch, cfg.max_seq_len, 0), model, opt)
    # windows alternate: plain, then after one discarded warm-up replay
    methods = [0, 1] if a.warmup_windows else [0]
    seen = {(arm, m): [] for arm in arms for m in methods}
    preludes = {arm: [] for arm in arms}
    tmp = tempfile.mkdtemp(prefix="observe_probe_")
    for r in range(a.rounds):
        for i in range(len(arms)):
            arm = arms[(r + i) % len(arms)]
            preludes[arm].append(_prelude(arm, hvt, cfg, a.batch,
                                          os.path.join(tmp, f"{arm}{r}")))
            for w in range(a.windows):
                m = methods[w % len(methods)]
                seen[arm, m].append((r, w, _window(replay, a.replays, m)))
    # every window replays the same graph: the fullest is the reference
    full = max((names for v in seen.values() for *_, names in v), key=len)
    want = collections.Counter(full)
    out = {}
    for (arm, m), windows in seen.items():
        short = []
        for r, w, names in windows:
            if len(names) == len(full):
                continue
            got = collections.Counter(names)
            short.append({"round": r, "window": w,
                          "kernels": len(names),
                          "missing": {n[:80]: want[n] - got[n] for n in want
                                      if got[n] < want[n]},
                          "extra": {n[:80]: got[n] - want[n] for n in got
                                    if got[n] > want[n]},
                          "missing_at": _missing_at(full, names)})
        out[arm + ("_warmup" if m else "")] = {
            "windows": len(windows), "short": len(short), "details": short}
    for arm in arms:
        if preludes[arm][0] is not None:
            # three eager steps of 12 layers
            out[arm]["prelude_flash_fwd"] = collections.Counter(
                preludes[arm])
    return {"kernels_per_window": len(full),
            "replays_per_window": a.replays,
            "flash_per_window": {n[:40]: c for n, c in want.items()
                                 if "flash" in n},
            "arms": out}


def _missing_at(full, names):
    """Where in the window (0 first kernel, 1 last) each lost record was."""
    import difflib

    sm = difflib.SequenceMatcher(None, full, names, autojunk=False)
    at = []
    for tag, i1, i2, _, _ in sm.get_opcodes():
        if tag in ("delete", "replace"):
            at += [round(i / (len(full) - 1), 4) for i in range(i1, i2)]
    return at[:20]


def cmd_run(a):
    hvt, cfg = _setup(a)
    import torch

    res = {"root": a.root, "tag": a.tag, "torch": torch.__version__,
           "cuda": torch.version.cuda, "main_path": _step_ms(a, cfg),
           "nvidia_smi": _smi() if a.device == "cuda" else "no GPU"}
    torch.cuda.empty_cache()
    if a.drops:
        t0 = time.perf_counter()
        res["drops"] = _drops(hvt, cfg, a)
        res["drops"]["seconds"] = time.perf_counter() - t0
    with open(a.result, "w") as f:
        json.dump(res, f)
    hvt.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cmd_worker(a):
    hvt, cfg = _setup(a)
    import torch

    res = _step_ms(a, cfg)
    res.update(rank=hvt.rank(), size=hvt.size(),
               peak_bytes=torch.cuda.max_memory_allocated())
    if hvt.rank() == 0:
        with open(a.result, "w") as f:
            json.dump(res, f)
    hvt.shutdown()


def _common(a):
    return ["--device", a.device, "--config", a.config, "--batch",
            str(a.batch)]


def _turns(parent):
    return [("parent", parent), ("change", REPO), ("change", REPO),
            ("parent", parent)]


def _summary(rows, key):
    by = collections.defaultdict(list)
    for r in rows:
        by[r["tag"]].append(r[key]["step_ms_median"]
                            if key else r["step_ms_median"])
    means = {t: statistics.mean(v) for t, v in by.items()}
    return {"step_ms_median": dict(by),
            "change_minus_parent_ms": means["change"] - means["parent"]}


def cmd_compare(a):
    os.makedirs(a.out, exist_ok=True)
    rows = []
    for i, (tag, root) in enumerate(_turns(a.parent)):
        result = os.path.join(a.out, f"run{i}_{tag}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "run",
               "--root", root, "--tag", tag, "--result", result,
               "--steps", str(a.steps), "--rounds", str(a.rounds),
               "--windows", str(a.windows), "--replays", str(a.replays),
               *_common(a)]
        if i < 2 and a.device == "cuda":   # a capture needs CUDA
            cmd.append("--drops")
        with open(result + ".log", "w") as log:
            rc = subprocess.run(cmd, cwd=root, stdout=log,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=root),
                                timeout=a.timeout).returncode
        if rc:
            with open(result + ".log") as f:
                sys.stderr.write(f.read()[-6000:])
            raise SystemExit(f"{tag} run {i} failed with {rc}")
        with open(result) as f:
            row = json.load(f)
        rows.append(row)
        brief = {k: v for k, v in row.items() if k != "drops"}
        brief["main_path"] = {k: v for k, v in row["main_path"].items()
                              if k != "losses"}
        if "drops" in row:
            brief["drops"] = {arm: {k: v for k, v in d.items()
                                    if k != "details"}
                              for arm, d in row["drops"]["arms"].items()}
        print(json.dumps(brief), flush=True)
    same = all(r["main_path"]["losses"] == rows[0]["main_path"]["losses"]
               for r in rows)
    print(json.dumps({"summary": "main path, one card",
                      "nvidia_smi": rows[0]["nvidia_smi"],
                      "losses_equal": same, **_summary(rows, "main_path")}))


def cmd_compare4(a):
    os.makedirs(a.out, exist_ok=True)
    rows = []
    for i, (tag, root) in enumerate(_turns(a.parent)):
        result = os.path.join(a.out, f"four{i}_{tag}.json")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "4", "--master-port", str(_free_port()),
               sys.executable, os.path.abspath(__file__), "worker",
               "--root", root, "--result", result, "--steps", str(a.steps),
               *_common(a)]
        with open(result + ".log", "w") as log:
            rc = subprocess.run(cmd, cwd=root, stdout=log,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=root,
                                         OMP_NUM_THREADS="1"),
                                timeout=a.timeout).returncode
        if rc:
            with open(result + ".log") as f:
                sys.stderr.write(f.read()[-6000:])
            raise SystemExit(f"{tag} job {i} failed with {rc}")
        with open(result) as f:
            row = dict(json.load(f), tag=tag)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "losses"}),
              flush=True)
    print(json.dumps({"summary": "main path, four cards",
                      "nvidia_smi": _smi() if a.device == "cuda"
                      else "no GPU",
                      "losses_equal": all(r["losses"] == rows[0]["losses"]
                                          for r in rows),
                      **_summary(rows, None)}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("compare", "compare4"):
        c = sub.add_parser(name)
        c.add_argument("--parent", required=True)
        c.add_argument("--out", default=os.path.join(
            REPO, "chiprun_out", "observe_probe"))
        c.add_argument("--steps", type=int, default=20)
        c.add_argument("--rounds", type=int, default=6)
        c.add_argument("--windows", type=int, default=4)
        c.add_argument("--replays", type=int, default=2)
        c.add_argument("--timeout", type=int, default=900)
    for name in ("run", "worker"):
        c = sub.add_parser(name)
        c.add_argument("--root", required=True)
        c.add_argument("--result", required=True)
        c.add_argument("--steps", type=int, default=20)
        c.add_argument("--tag", default="")
        c.add_argument("--drops", action="store_true")
        c.add_argument("--warmup-windows", action="store_true")
        c.add_argument("--rounds", type=int, default=6)
        c.add_argument("--windows", type=int, default=4)
        c.add_argument("--replays", type=int, default=2)
    for c in sub.choices.values():
        # cpu and a small config rehearse the commands without a GPU
        c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        c.add_argument("--config", default="bench")
        c.add_argument("--batch", type=int, default=8)
    a = p.parse_args(argv)
    a.parent = os.path.abspath(a.parent) if getattr(a, "parent", None) \
        else None
    {"compare": cmd_compare, "compare4": cmd_compare4, "run": cmd_run,
     "worker": cmd_worker}[a.cmd](a)


if __name__ == "__main__":
    main()
