"""The port's launcher utilities against the JAX package's
(``tests/test_runner_util.py:25-195``): the secret, the host hash, the
``mpirun`` commands of OpenMPI and MPICH with the large-cluster flags and
env forwarding, ``env_from_mpi``, ``lsf_hosts``, the ``jsrun`` command,
the probe's ring and a bad signature, and the interfaces. Each case is held
to the JAX function's output on the same inputs. Then the launcher's
flags: ``--stall-warning-sec`` in every slot's environment, ``--use-mpi``
and ``--use-jsrun`` dispatching to their commands, the identity a worker
takes from MPI's environment, and the probe's rendezvous address."""

import os
import sys
import types

import pytest

from horovod_tpu.runner import host_hash as j_host_hash
from horovod_tpu.runner import js_run as j_js
from horovod_tpu.runner import mpi_run as j_mpi
from horovod_tpu.runner import network as j_network
from horovod_tpu.runner import probe as j_probe
from horovod_tpu.runner import secret as j_secret
from horovod_tpu_torch.runner import host_hash, js_run, mpi_run, network, \
    probe, secret


def test_secret_roundtrip_and_digest_match_the_jax_package():
    key = secret.make_secret_key()
    payload = b"host-update:1"
    digest = secret.compute_digest(key, payload)
    assert digest == j_secret.compute_digest(key, payload)
    assert secret.check_digest(key, payload, digest)
    assert j_secret.check_digest(key, payload, digest)
    assert not secret.check_digest(key, b"tampered", digest)
    assert not secret.check_digest(secret.make_secret_key(), payload,
                                   digest)


@pytest.mark.parametrize("salt", ["", "a", "b", "slot-3"])
def test_host_hash_matches_the_jax_package(salt):
    assert host_hash.host_hash(salt) == j_host_hash.host_hash(salt)
    assert host_hash.host_hash("a") != host_hash.host_hash("b")


@pytest.mark.parametrize("a,b", [("localhost", "127.0.0.1"),
                                 ("localhost", "definitely-not-a-host-xyz"),
                                 ("h1", "h1")])
def test_hosts_equivalent_matches_the_jax_package(a, b):
    assert host_hash.hosts_equivalent(a, b) == \
        j_host_hash.hosts_equivalent(a, b)


ENV = {"HVT_COORDINATOR_ADDR": "h1:29510", "PATH": "/bin",
       "PYTHONPATH": "/r", "SECRET": "x"}


@pytest.mark.parametrize("impl", [mpi_run.OPENMPI, mpi_run.MPICH,
                                  mpi_run.SPECTRUM, mpi_run.INTEL,
                                  mpi_run.UNKNOWN])
@pytest.mark.parametrize("n_hosts", [2, 80])
def test_mpirun_command_matches_the_jax_package(impl, n_hosts):
    hosts = ",".join(f"h{i}:2" for i in range(n_hosts))
    args = (2 * n_hosts, hosts, ["python", "train.py"], ENV)
    got = mpi_run.build_mpirun_command(*args, impl=impl, ssh_port=2222)
    assert got == j_mpi.build_mpirun_command(*args, impl=impl,
                                             ssh_port=2222)
    s = " ".join(got)
    assert got[0] == "mpirun" and "SECRET" not in s
    assert ("plm_rsh_no_tree_spawn" in s) == \
        (n_hosts > 64 and impl == mpi_run.OPENMPI)
    if impl == mpi_run.OPENMPI:
        assert "-x HVT_COORDINATOR_ADDR" in s and "-p 2222" in s
    if impl == mpi_run.MPICH:
        assert "-genvlist" in s and "-hosts h0,h1" in s


@pytest.mark.parametrize("keys", [[], ["A"], ["A", "B"]])
def test_env_forward_args_match_the_jax_package(keys):
    for impl in (mpi_run.OPENMPI, mpi_run.MPICH, mpi_run.INTEL):
        assert mpi_run.env_forward_args(impl, keys) == \
            j_mpi.env_forward_args(impl, keys)


@pytest.mark.parametrize("env", [
    {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    {"PMI_RANK": "5", "PMI_SIZE": "6", "MPI_LOCALRANKID": "1",
     "MPI_LOCALNRANKS": "2"},
    {"HVT_PROCESS_ID": "0", "OMPI_COMM_WORLD_RANK": "3"},
    {}])
def test_env_from_mpi_matches_the_jax_package(env):
    got = mpi_run.env_from_mpi(env)
    assert got == j_mpi.env_from_mpi(env)
    assert not set(got) & {k for k, v in env.items() if v}


@pytest.mark.parametrize("env", [
    {"LSB_MCPU_HOSTS": "launcher1 1 node1 4 node2 4"},
    {"LSB_MCPU_HOSTS": "launcher1 1 batch01 4 batch02 4"},
    {"LSB_HOSTS": "launcher node1 node1 node2"},
    {"LSB_MCPU_HOSTS": "only 4"}, {}])
def test_lsf_hosts_match_the_jax_package(env):
    assert js_run.lsf_hosts(env) == j_js.lsf_hosts(env)
    assert js_run.in_lsf_env(env) == j_js.in_lsf_env(env)


@pytest.mark.parametrize("smpiargs", ["-disable_gpu_hooks", ""])
def test_jsrun_command_matches_the_jax_package(smpiargs):
    cmd = js_run.build_jsrun_command(8, ["python", "t.py"], smpiargs)
    assert cmd == j_js.build_jsrun_command(8, ["python", "t.py"], smpiargs)
    assert cmd[:2] == ["jsrun", "-n8"] and cmd[-2:] == ["python", "t.py"]


def test_probe_ring_matches_the_jax_package():
    """Two task services of each package on this machine, one key: each
    package's driver gets the same host information, ring and common
    interfaces from the other's services."""
    key = secret.make_secret_key()
    ours = [probe.TaskService(i, key, salt=str(i)) for i in range(2)]
    theirs = [j_probe.TaskService(i, key, salt=str(i)) for i in range(2)]
    a = [f"127.0.0.1:{t.start()}" for t in ours]
    b = [f"127.0.0.1:{t.start()}" for t in theirs]
    try:
        drv, j_drv = probe.DriverProbe(key), j_probe.DriverProbe(key)
        infos = drv.collect_info(a)
        assert infos[0]["host_hash"] != infos[1]["host_hash"]
        assert infos == j_drv.collect_info(b) == drv.collect_info(b)
        common = drv.common_interfaces(a)
        assert "lo" in common and common == j_drv.common_interfaces(b)
        reach = drv.reachable_addresses(a)
        assert all("127.0.0.1" in v for v in reach.values())
        assert reach == j_drv.reachable_addresses(b)
        assert probe.wait_for_service(a[0], timeout=2)
    finally:
        for t in ours + theirs:
            t.stop()


def test_probe_rejects_a_bad_signature():
    import urllib.error

    key = secret.make_secret_key()
    t = probe.TaskService(0, key)
    port = t.start()
    try:
        for bad in (probe.DriverProbe(secret.make_secret_key()),
                    j_probe.DriverProbe(secret.make_secret_key())):
            with pytest.raises(urllib.error.HTTPError) as e:
                bad.collect_info([f"127.0.0.1:{port}"])
            assert e.value.code == 403
    finally:
        t.stop()


def test_interfaces_match_the_jax_package():
    assert network.get_local_interfaces() == j_network.get_local_interfaces()
    assert network.local_addresses() == j_network.local_addresses()
    assert "127.0.0.1" in network.local_addresses()
    per_host = {"0": ["a", "b"], "1": ["b", "c"]}
    assert network.filter_common_interfaces(per_host) == \
        j_network.filter_common_interfaces(per_host) == ["b"]
    assert "lo" in network._ioctl_interfaces()


def test_rendezvous_address_from_the_probe():
    """Two 'hosts' served from this process: the address of the first
    that the ring reached, never a loopback one."""
    addrs = [a for a in network.local_addresses()
             if not a.startswith("127.")]
    if not addrs:
        with pytest.raises(RuntimeError, match="answered the probe"):
            probe.rendezvous_address(["a", "b"], lambda h: True)
    else:
        assert probe.rendezvous_address(["a", "b"], lambda h: True) in addrs


# ------------------------------------------------------------ launcher

def test_stall_warning_sec_reaches_every_slot():
    from horovod_tpu_torch.runner import launch
    from horovod_tpu_torch.runner.hosts import get_host_assignments, \
        parse_hosts

    for argv, want in ((["-np", "2", "python", "t.py"], "60"),
                       (["-np", "2", "--stall-warning-sec", "7", "python",
                         "t.py"], "7")):
        args = launch.parse_args(argv)
        slots = get_host_assignments(parse_hosts("localhost:2"), 2)
        cmds = launch.build_commands(args, slots, "127.0.0.1", base_env={})
        assert [env["HVT_STALL_WARN_SEC"] for _, env, _ in cmds] == \
            [want, want]


@pytest.mark.parametrize("flag,module", [("--use-mpi", "mpi_run"),
                                         ("--use-jsrun", "js_run")])
def test_use_mpi_and_jsrun_dispatch(flag, module, monkeypatch):
    """The launcher hands the job to the module's runner, which runs one
    command with the job's environment."""
    from horovod_tpu_torch.runner import launch

    ran = []
    mod = {"mpi_run": mpi_run, "js_run": js_run}[module]
    monkeypatch.setattr(mpi_run, "get_mpi_implementation",
                        lambda: mpi_run.OPENMPI)
    monkeypatch.setattr(js_run.shutil, "which", lambda name: "/bin/jsrun")
    monkeypatch.setattr(mod.subprocess, "run", lambda cmd, env: (
        ran.append((cmd, env)), types.SimpleNamespace(returncode=0))[1])
    assert launch.main(["-np", "2", flag, "--stall-warning-sec", "3",
                        "python", "t.py"]) == 0
    (cmd, env), = ran
    assert cmd[0] == ("mpirun" if module == "mpi_run" else "jsrun")
    assert cmd[-2:] == ["python", "t.py"]
    assert env["HVT_STALL_WARN_SEC"] == "3" and env["HVT_FROM_MPI"] == "1"
    assert env["HVT_COORDINATOR_ADDR"] == "127.0.0.1:29510"


def test_check_build_reports_mpirun_and_jsrun(capsys):
    from horovod_tpu_torch.runner import launch

    assert launch.main(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "mpirun on PATH (--use-mpi)" in out
    assert "jsrun on PATH (--use-jsrun)" in out


def test_a_worker_takes_its_identity_from_mpi(monkeypatch):
    from horovod_tpu_torch.common import basics

    # a copy of the environment, so that nothing derived here leaks
    monkeypatch.setattr(os, "environ", {k: v for k, v in os.environ.items()
                                        if not k.startswith("HVT_")})
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "5")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "8")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_SIZE", "4")
    basics._identity_from_mpi()
    got = {k: os.environ[k] for k in os.environ if k.startswith("HVT_")}
    assert got == {"HVT_PROCESS_ID": "5", "HVT_NUM_PROCESSES": "8",
                   "HVT_LOCAL_PROCESS_ID": "1", "HVT_LOCAL_SIZE": "4",
                   "HVT_CROSS_RANK": "1", "HVT_CROSS_SIZE": "2"}
    for k in got:
        del os.environ[k]
    for k in ("RANK", "SIZE", "LOCAL_RANK", "LOCAL_SIZE"):
        del os.environ[f"OMPI_COMM_WORLD_{k}"]
    monkeypatch.setenv("JSM_NAMESPACE_RANK", "2")
    monkeypatch.setenv("JSM_NAMESPACE_SIZE", "4")
    basics._identity_from_mpi()
    assert os.environ["HVT_PROCESS_ID"] == "2" and \
        os.environ["HVT_NUM_PROCESSES"] == "4"


def test_split_list_and_exceptions_match_the_jax_package():
    from horovod_tpu.common import exceptions as jx
    from horovod_tpu.common.util import split_list as j_split
    from horovod_tpu_torch.common import exceptions as px
    from horovod_tpu_torch.common.util import split_list

    for n in range(9):
        for parts in range(1, 6):
            xs = list(range(n))
            assert split_list(xs, parts) == j_split(xs, parts)
    for name in ("TensorShapeMismatchError", "TensorDtypeMismatchError",
                 "HorovodVersionMismatchError"):
        assert getattr(px, name).__mro__[1] is getattr(jx, name).__mro__[1]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
