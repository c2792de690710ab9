"""The port's tools (``horovod_tpu_torch/tools/``) against the JAX
package's: ``hvt_top`` renders a port ``/statusz`` as the JAX tool does
and prints it with ``--once --json`` (exit 2 when the server is gone);
``hvt_analyze`` reads a launched 3-process gloo gang's timeline, whose
coordinator lanes carry the phases, and ranks the rank seeded to arrive
late first among the stragglers; ``--diff`` gives the JAX tool's verdict
and text on the same pair of reports."""

import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRAGGLER = 2
CALLS = 8
# how late the straggler arrives: well past the error of the ranks' clock
# alignment to the launcher's on a loaded machine (the arrivals are
# stamped by the ranks that arrive)
LATE_S = 0.3

WORKER = textwrap.dedent(f"""
    import time
    import torch
    import horovod_tpu_torch as hvt
    hvt.init(device="cpu")
    x = torch.ones(64)
    for i in range({CALLS}):
        if hvt.rank() == {STRAGGLER}:
            time.sleep({LATE_S})       # this rank arrives last
        hvt.allreduce(x, name="grad")
    hvt.barrier()
    hvt.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(*argv):
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyze")
    script, path = d / "worker.py", str(d / "trace.json")
    script.write_text(WORKER)
    proc = _run("-m", "horovod_tpu_torch.runner.launch", "-np", "3",
                "--master-port", str(_free_port()), "--timeline", path,
                sys.executable, str(script))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return path


def test_hvt_analyze_ranks_the_seeded_straggler_first(trace, tmp_path):
    from horovod_tpu_torch.tools import hvt_analyze

    rep = hvt_analyze.analyze_paths([trace])
    assert rep["ranks"] == [0, 1, 2]
    assert rep["negotiations_scored"] >= CALLS
    top = rep["stragglers"][0]
    assert top["rank"] == STRAGGLER
    # last in most negotiations (a loaded machine may delay another rank
    # past the straggler's sleep now and then), by about its sleep
    assert top["times_last"] > CALLS // 2
    assert top["mean_margin_us"] > LATE_S * 1e6 / 3
    for phase in ("queue", "negotiate", "exec", "e2e"):
        assert rep["phases"][phase]["count"] >= CALLS, phase
    assert set(rep["overlap_efficiency"]) == {"0", "1", "2"}
    assert "grad" in rep["per_tensor"] and rep["lanes"]["0"]["count"]
    assert "wire" not in rep["phases"] and rep["cycles"]["count"] == 0
    out = tmp_path / "report.json"
    proc = _run("-m", "horovod_tpu_torch.tools.hvt_analyze", trace, "-o",
                str(out))
    assert proc.returncode == 0, proc.stderr
    assert "straggler ranking" in proc.stdout
    with open(out) as f:
        assert json.load(f)["stragglers"][0]["rank"] == STRAGGLER


def test_hvt_analyze_reads_raw_shards(trace):
    from horovod_tpu_torch.tools import hvt_analyze

    shards = [f"{trace}.rank{r}" for r in range(3)]
    rep = hvt_analyze.analyze_paths(shards)
    assert rep["stragglers"][0]["rank"] == STRAGGLER


@pytest.mark.parametrize("scale", [1.0, 3.0, 0.2])
def test_hvt_analyze_diff_matches_the_jax_tool(trace, tmp_path, scale):
    from horovod_tpu.tools import hvt_analyze as jax_tool
    from horovod_tpu_torch.tools import hvt_analyze

    base = hvt_analyze.analyze_paths([trace])
    base["metrics"]["queue_us_p50"] = 1000.0     # above the noise floor
    cur = dict(base, metrics={k: v * scale
                              for k, v in base["metrics"].items()})
    if scale == 1.0:
        del cur["metrics"]["queue_us_p50"]          # a gated key missing
    paths = [str(tmp_path / "base.json"), str(tmp_path / "cur.json")]
    for p, rep in zip(paths, (base, cur)):
        with open(p, "w") as f:
            json.dump(rep, f)
    mine, theirs = io.StringIO(), io.StringIO()
    rc = hvt_analyze.run_diff(*paths, 2.0, 200.0, out=mine)
    # a key gone from the current report, or a p50 3x slower, fails
    assert rc == jax_tool.run_diff(*paths, 2.0, 200.0, out=theirs) == \
        (0 if scale < 1 else 1)
    assert mine.getvalue() == theirs.getvalue()
    assert hvt_analyze.diff_metrics(base["metrics"], cur["metrics"]) == \
        jax_tool.diff_metrics(base["metrics"], cur["metrics"])
    if scale == 3.0:    # the command line gives the same verdict
        proc = _run("-m", "horovod_tpu_torch.tools.hvt_analyze", "--diff",
                    *paths)
        assert proc.returncode == 1 and proc.stdout == mine.getvalue()


def _statusz_server():
    """A port KV server with a stalled negotiation pushed by rank 0."""
    from horovod_tpu_torch.metrics import telemetry
    from horovod_tpu_torch.runner import http_client
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    class Slot:
        def __init__(self, r):
            self.hostname, self.rank, self.local_rank = "h0", r, r
            self.local_size, self.size, self.cross_size = 2, 2, 1
            self.cross_rank = 0

    server = RendezvousServer(lambda s, r: 0)
    server.init([Slot(0), Slot(1)])
    addr = f"127.0.0.1:{server.start(0)}"
    row = {"tensor": "lonely", "op": "ALLREDUCE", "waiting_sec": 75.0,
           "arrived_ranks": [1], "missing_ranks": [0]}
    for r in range(2):
        diag = {"process_rank": r, "pending": [], "joined": False,
                "negotiations": [row] if r == 0 else [],
                "stalls": [row] if r == 0 else [],
                "stall_warn_sec": 60.0,
                "engine": {"running": False, "queue_depth": 0,
                           "wire": {"intra": "none", "inter": "none",
                                    "auto": False}}}
        snap = telemetry.build_snapshot(r, "h0", diag, {})
        http_client.put_bytes(addr, f"/kv/debugz/{r}",
                              json.dumps(snap).encode(), retries=0)
    return server, addr


def test_hvt_top_once_json_and_render_match_the_jax_tool(capsys):
    from horovod_tpu.tools import hvt_top as jax_top
    from horovod_tpu_torch.tools import hvt_top

    server, addr = _statusz_server()
    try:
        proc = _run("-m", "horovod_tpu_torch.tools.hvt_top", "--addr", addr,
                    "--once", "--json")
        assert proc.returncode == 0, proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["schema"] == "hvt-statusz-r1"
        assert doc["ranks_covered"] == doc["ranks_expected"] == 2
        assert set(doc) == set(hvt_top.fetch(addr))
        text = hvt_top.render(doc, "12:00:00")
        assert text == jax_top.render(doc, "12:00:00")
        assert text.startswith("hvt_top — 2/2 ranks")
        assert hvt_top.main(["--addr", addr, "--once"]) == 0
        assert "ranks (" in capsys.readouterr().out
    finally:
        server.stop()
    assert hvt_top.main(["--addr", addr, "--once", "--json"]) == 2
    assert "cannot reach" in capsys.readouterr().err
