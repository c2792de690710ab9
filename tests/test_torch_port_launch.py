"""horovod_tpu_torch's launcher (``python -m horovod_tpu_torch.runner.launch``)
held against the JAX package's ``runner/``: host parsing and rank
assignment, the slot env, the config file; then real launches on the CPU:
``-np 2`` workers that report their identity and train the entry GPT, and
a job whose first failure stops the rest."""

import os
import shlex
import sys
import time

import numpy as np
import pytest
import torch

import torch_port_launch_worker as W
from horovod_tpu.runner import config_parser as jcfg
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu_torch.models import GPT
from horovod_tpu_torch.runner import config_parser, hosts, launch
from horovod_tpu_torch.train import gpt_config, loss_fn

GPT_ARGS = dict(device="cpu", config="entry", steps=2, batch=2, seq=32)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    j = W.Launch(2, "gpt", str(tmp_path_factory.mktemp("launch") / "res"),
                 GPT_ARGS)
    yield j
    j.kill()


HOST_CASES = {
    "even": ("localhost:4", 4),
    "uneven": ("a:2,b:1,c:3", 6),
    "more_hosts_than_needed": ("a:2,b:2,c:2", 3),
    "partial_last": ("a:3,b:3", 5),
    "default_slots": ("a,b,c:2", 4),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_assignments_equal_the_reference(case):
    spec, n = HOST_CASES[case]
    got = hosts.get_host_assignments(hosts.parse_hosts(spec), n)
    want = jhosts.get_host_assignments(jhosts.parse_hosts(spec), n)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert [hosts.slot_env_vars(s) for s in got] == \
        [jhosts.slot_env_vars(s) for s in want]


def test_np_over_capacity_raises_as_the_reference():
    for mod in (hosts, jhosts):
        with pytest.raises(ValueError, match="exceeds available slots"):
            mod.get_host_assignments(mod.parse_hosts("a:2,b:1"), 4)


def test_hostfile_parses_as_the_reference(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text("# cluster\nnode1 slots=4\nnode2 slots=2  # gpu\n"
                    "node3:3\n\nnode4\n")
    got = hosts.parse_hostfile(str(path))
    assert [vars(h) for h in got] == \
        [vars(h) for h in jhosts.parse_hostfile(str(path))]
    assert [(h.hostname, h.slots) for h in got] == [
        ("node1", 4), ("node2", 2), ("node3", 3), ("node4", 1)]


@pytest.mark.parametrize("spec", ["localhost:3", "localhost:2,remote:2"])
def test_slot_env_equals_the_reference_key_by_key(spec):
    """Every HVT_ key the port writes, against the JAX launcher's
    ``--backend jax`` env (which writes HVT_COORDINATOR_ADDR, the contract
    of basics.init, and the stall inspector's HVT_STALL_WARN_SEC); the
    engine tuning keys are the reference's alone."""
    n = sum(int(p.split(":")[1]) for p in spec.split(","))
    base = {"PATH": "/bin", "KEEP": "1"}
    argv = ["-np", str(n), "-H", spec, "--master-port", "31000", "python",
            "train.py"]
    args = launch.parse_args(argv)
    jargs = jlaunch.parse_args(argv + [])
    jargs.backend = "jax"
    slots = hosts.get_host_assignments(hosts.parse_hosts(spec), n)
    got = launch.build_commands(args, slots, "10.0.0.1", base_env=base)
    want = jlaunch.build_commands(jargs, slots, "10.0.0.1", base_env=base)
    engine_only = {"HVT_CYCLE_TIME_MS", "HVT_FUSION_THRESHOLD"}
    for (cmd, env, rank), (jcmd, jenv, jrank) in zip(got, want):
        assert rank == jrank
        if cmd[0] == "ssh":     # the env rides inline, as the reference's
            assert cmd[:-1] == jcmd[:-1]
            assert set(shlex.split(cmd[-1])) <= set(shlex.split(jcmd[-1]))
            assert f"HVT_PROCESS_ID={rank}" in cmd[-1]
            continue
        assert cmd == jcmd == ["python", "train.py"]
        hvt_keys = {k for k in env if k.startswith("HVT_")}
        assert hvt_keys == {k for k in jenv if k.startswith("HVT_")} \
            - engine_only
        for key in hvt_keys:
            assert env[key] == jenv[key], key
        assert env["KEEP"] == "1"
        assert env["HVT_COORDINATOR_ADDR"] == "10.0.0.1:31000"


def test_ssh_command_inlines_the_same_env_as_the_reference():
    args = launch.parse_args(["-np", "2", "-H", "remote:2", "python", "x.py"])
    slot = hosts.get_host_assignments(hosts.parse_hosts("remote:2"), 2)[1]
    env = launch.slot_env({"PATH": "/bin"}, slot, args, "remote")
    got = launch._ssh_command(env, "remote", 2222, ["python", "x.py"])
    assert got == jlaunch._ssh_command(env, "remote", 2222,
                                       ["python", "x.py"])
    assert "HVT_PROCESS_ID=1" in got[-1] and "-p" in got


def test_config_file_as_the_reference(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("master-port: 31234\nssh-port: 2200\nverbose: true\n")
    got = launch.parse_args(["--config-file", str(path), "-np", "1",
                             "--ssh-port", "23", "python", "x.py"])
    want = jlaunch.parse_args(["--config-file", str(path), "-np", "1",
                               "--ssh-port", "23", "python", "x.py"])
    for key in ("master_port", "ssh_port", "verbose"):
        assert getattr(got, key) == getattr(want, key), key
    assert (got.master_port, got.ssh_port) == (31234, 23)  # the CLI wins
    assert config_parser.load_config(str(path)) == jcfg.load_config(
        str(path))
    path.write_text("cycle-time-ms: 3\n")     # an engine knob: not the port's
    with pytest.raises(ValueError, match="unknown config keys"):
        config_parser.load_config(str(path))


def test_check_build_and_usage(capsys):
    assert launch.main(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "[X] PyTorch" in out and "Gloo" in out
    assert launch.main(["python", "x.py"]) == 2     # no -np
    with pytest.raises(SystemExit):
        launch.parse_args(["-np", "2"])             # no command


def test_launched_workers_report_their_identity(job):
    results = job.results()
    port = None
    for r, res in enumerate(results):
        env = res["env"]
        assert (res["rank"], res["size"], res["local_rank"],
                res["local_size"], res["cross_rank"],
                res["cross_size"]) == (r, 2, r, 2, 0, 1)
        assert env["HVT_PROCESS_ID"] == str(r)
        assert env["HVT_NUM_PROCESSES"] == "2"
        assert env["HVT_HOSTNAME"] == "localhost"
        host, _, p = env["HVT_COORDINATOR_ADDR"].partition(":")
        assert host == "127.0.0.1" and p == (port or p)
        port = p
        assert res["device"] == "cpu"
        assert all(np.isfinite(res["losses"]))


def test_launched_training_matches_one_process(job):
    """The first step's loss, averaged over the two ranks, is the loss of
    the whole 4-row batch in one process; the second follows the averaged
    gradient, so the ranks' parameters agree and both losses fall."""
    results = job.results()
    cfg = gpt_config("entry", use_flash=True)
    model = GPT(cfg, device="cpu", seed=0)
    rows = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2 * GPT_ARGS["batch"], GPT_ARGS["seq"]))
    with torch.no_grad():
        whole = float(loss_fn(model, torch.from_numpy(rows)))
    first = np.mean([res["losses"][0] for res in results])
    np.testing.assert_allclose(first, whole, rtol=1e-5)
    for res in results:
        assert res["losses"][1] < res["losses"][0]
        assert res["launches"] == {name: 0 for name in res["launches"]}


def test_first_failure_stops_the_rest(tmp_path):
    t0 = time.perf_counter()
    rc, log = W.Launch(3, "fail", str(tmp_path / "res"), {"sleep": 120},
                       timeout=90).wait()
    assert rc == 1, log
    assert "ranks failed" in log and "(1, 3)" in log
    assert time.perf_counter() - t0 < 60


def test_launcher_runs_as_a_module(tmp_path):
    """``python -m horovod_tpu_torch.runner.launch`` end to end with a
    plain command: each slot's env reaches the child."""
    import subprocess

    script = tmp_path / "show.py"
    script.write_text("import os\nprint('SLOT', os.environ['HVT_PROCESS_ID'],"
                      " os.environ['HVT_LOCAL_SIZE'])\n")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", sys.executable, str(script)], capture_output=True, text=True,
        timeout=60, cwd=W.REPO, env=dict(os.environ, PYTHONPATH=W.REPO))
    assert out.returncode == 0, out.stderr
    assert sorted(line.split("] ", 1)[1] for line in out.stdout.splitlines()
                  if "SLOT" in line) == ["SLOT 0 2", "SLOT 1 2"]
