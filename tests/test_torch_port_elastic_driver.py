"""The port's elastic launcher (``horovod_tpu_torch/runner/elastic``,
``runner/http_server.py``, ``elastic/preemption.py``) held against the JAX
package's on the same inputs: discovery-script parsing, the host manager's
order and blacklist, the registry's round barrier, the driver's rank
assignments over scripted rounds (fail, shrink, grow), the rendezvous
server's answers, the launcher's elastic flags and the preemption
watcher's reports. Then the port's own parts: the driver's abort of a dead
worker's peers, and three launched gloo gangs of
tests/torch_port_elastic_worker.py, one after another (each is killed
after 110 s):

- ``-np 3 --min-np 2``: the worker of slot 2 rewrites the discovery to
  ``localhost:2`` and SIGKILLs itself after commit 3; the survivors finish
  at size 2 with every row committed exactly once and equal parameters;
- the same, then rank 0 writes ``localhost:3`` back: a fresh worker joins
  at the next commit and sync() brings it to rank 0's state;
- ``-np 4`` with ReplicatedTorchState: the killed slot is respawned and
  rebuilds its lineage from its peer's shard, bit for bit.
"""

import copy
import json
import os
import signal
import subprocess
import threading
import time

import pytest

import torch_port_elastic_worker as EW
from horovod_tpu.runner import http_server as jhttp
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner.elastic import discovery as jdisc
from horovod_tpu.runner.elastic import driver as jdriver
from horovod_tpu.runner.elastic import registration as jreg
from horovod_tpu.runner.elastic import settings as jsettings
from horovod_tpu_torch.runner import http_client, http_server, launch
from horovod_tpu_torch.runner.elastic import (discovery, driver,
                                              notification, registration,
                                              settings)

PORT = (discovery, driver, registration, settings, http_server)
JAX = (jdisc, jdriver, jreg, jsettings, jhttp)
GPT = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
           max_seq_len=16)
JOB_TIMEOUT = 110


BASE = dict(device="cpu", gpt=GPT, timeout_s=30)
JOBS = {
    "shrink": (3, dict(BASE, rows=48, batch=2, record_restored_step=True,
                       kill={"slot": 2, "after_commit": 3,
                             "hosts": "localhost:2"})),
    # 153 rows: 3 commits of 9 rows, then steps of 6 at size 2, split over
    # 3 again wherever the grow lands: no row is padded twice
    "grow": (3, dict(BASE, rows=153, batch=3, sleep=0.1, kill={
        "slot": 2, "after_commit": 3, "hosts": "localhost:2"},
        grow={"after_commit": 2, "hosts": "localhost:3"})),
    "replicated": (4, dict(BASE, rows=48, batch=2, state="replicated",
                           steps=6, kill={"slot": 3, "after_commit": 3})),
}


# --------------------------------------------------------------- discovery

def _rendezvous(http):
    """A rendezvous server of ``http`` (the port's or the JAX package's)
    publishing TCP store port 40000 + round: the port takes the function
    as its argument, the JAX package as an attribute."""
    fn = lambda slots, rnd: 40000 + rnd     # noqa: E731
    if http is http_server:
        return http.RendezvousServer(fn)
    server = http.RendezvousServer()
    server.master_port_fn = fn
    return server


def _script(tmp_path, body):
    path = tmp_path / "discover.sh"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("body,default", [
    ("echo host-1:2\necho host-2\necho '  '\n", 4),
    ("echo a:1\necho b:x\necho c:3\n", 1),
    ("printf 'x:2\\ny:2\\nx:5\\n'\n", 2),
    ("true\n", 1),
])
def test_discovery_script_matches_reference(tmp_path, body, default):
    script = _script(tmp_path, body)
    got = discovery.HostDiscoveryScript(script, default)
    want = jdisc.HostDiscoveryScript(script, default)
    assert got.find_available_hosts_and_slots() == \
        want.find_available_hosts_and_slots()


def test_failing_discovery_keeps_the_view_as_the_reference(tmp_path):
    script = _script(tmp_path, "echo host-1:2\n")
    mgrs = [mod.HostManager(mod.HostDiscoveryScript(script))
            for mod in (discovery, jdisc)]
    assert [m.update_available_hosts() for m in mgrs] == [True, True]
    _script(tmp_path, "exit 1\n")
    for m in mgrs:
        with pytest.raises(subprocess.CalledProcessError):
            m.update_available_hosts()
    assert mgrs[0].current_hosts == discovery.DiscoveredHosts(
        mgrs[1].current_hosts.host_slots,
        mgrs[1].current_hosts.host_assignment_order)


class _Sequence:
    def __init__(self, *sets):
        self.sets, self.i = list(sets), 0

    def find_available_hosts_and_slots(self):
        hosts = self.sets[min(self.i, len(self.sets) - 1)]
        self.i += 1
        return dict(hosts)


HOST_SEQUENCE = [{"a": 2, "b": 2}, {"b": 2, "c": 2, "a": 2}, {"c": 1},
                 {"d": 4, "c": 1, "a": 1}, {"a": 1, "d": 4}]


def test_host_manager_order_and_blacklist_match_reference():
    views = []
    for mod in (discovery, jdisc):
        mgr = mod.HostManager(_Sequence(*HOST_SEQUENCE))
        seen = []
        for i in range(len(HOST_SEQUENCE)):
            changed = mgr.update_available_hosts()
            if i == 1:
                mgr.blacklist("b")
            seen.append((changed, mgr.current_hosts.host_slots,
                         mgr.current_hosts.host_assignment_order,
                         mgr.current_hosts.count_available_slots(),
                         mgr.is_blacklisted("b"), mgr.blacklisted_count()))
        views.append(seen)
    assert views[0] == views[1]


def test_blacklist_cooldown_matches_reference():
    out = []
    for mod in (discovery, jdisc):
        mgr = mod.HostManager(mod.FixedHostDiscovery("a:1,b:2"),
                              cooldown_range=(0.01, 0.02))
        mgr.update_available_hosts()
        mgr.blacklist("a")
        first = (mgr.is_blacklisted("a"), mgr.current_hosts.host_slots)
        time.sleep(0.05)
        mgr.update_available_hosts()
        out.append((first, mgr.is_blacklisted("a"),
                    mgr.current_hosts.host_slots))
    assert out[0] == out[1]


# ---------------------------------------------------------------- registry

class _FakeDriver:
    def __init__(self):
        self.calls = []

    def resume(self):
        self.calls.append("resume")

    def stop(self, error=False, reason=None):
        self.calls.append(("stop", error, reason))


REGISTRY_SCRIPTS = {
    "all_success": (2, None, [("success", "a", 0), ("success", "a", 1)]),
    "failure_blacklists": (2, None, [("failure", "b", 0),
                                     ("success", "a", 0)]),
    "ready_resumes": (2, None, [("ready", "a", 0), ("ready", "a", 1)]),
    "first_terminal_wins": (2, None, [("failure", "a", 0),
                                      ("success", "a", 0),
                                      ("ready", "a", 1)]),
    "reset_limit": (1, 1, [("failure", "a", 0), ("reset", 1),
                           ("failure", "a", 0)]),
    "mixed_host": (3, None, [("failure", "b", 0), ("ready", "b", 1),
                             ("ready", "a", 0)]),
}


@pytest.mark.parametrize("name", sorted(REGISTRY_SCRIPTS))
def test_registry_barrier_matches_reference(name):
    size, limit, script = REGISTRY_SCRIPTS[name]
    out = []
    for disc, reg in ((discovery, registration), (jdisc, jreg)):
        drv = _FakeDriver()
        mgr = disc.HostManager(disc.FixedHostDiscovery({"a": 2, "b": 2}))
        mgr.update_available_hosts()
        r = reg.WorkerStateRegistry(drv, mgr, reset_limit=limit)
        r.reset(size)
        rounds = []
        for op, *args in script:
            if op == "reset":
                r.reset(args[0])
            else:
                rounds.append(getattr(r, f"record_{op}")(*args))
        out.append((drv.calls, rounds, r.reset_count, r.round,
                    [r.count(s) for s in ("READY", "SUCCESS", "FAILURE")],
                    mgr.is_blacklisted("a"), mgr.is_blacklisted("b")))
    assert out[0] == out[1]


# ------------------------------------------------------------------ driver

DRIVER_SCRIPTS = {
    # host sets the discovery returns, in order; exit codes by (round,
    # host, slot); the driver's min/max np and -np
    "fail_then_shrink": ([{"h1": 2, "h2": 2}, {"h1": 2, "h2": 2},
                          {"h1": 2}], {(1, "h2", 0): 1, (1, "h2", 1): 1},
                         2, 4, 4),
    "fail_respawn_same_size": ([{"h1": 2}], {(1, "h1", 1): 1}, 1, 2, 2),
    "fail_then_grow": ([{"h1": 2}, {"h1": 2}, {"h1": 2, "h2": 2}],
                       {(1, "h1", 0): 1}, 2, 4, 2),
    "below_min_np": ([{"h1": 1, "h2": 1}], {(1, "h2", 0): 1}, 2, 2, 2),
}


def _drive(mods, name):
    disc, drv_mod, _, sett, http = mods
    sets, codes, min_np, max_np, np_ = DRIVER_SCRIPTS[name]
    seen, lock = [], threading.Lock()
    rendezvous = _rendezvous(http)

    def worker(slot):
        with lock:
            rnd = rendezvous.round
            seen.append((rnd, slot.hostname, slot.local_rank, slot.rank,
                         slot.size, slot.local_size, slot.cross_rank,
                         slot.cross_size))
        return codes.get((rnd, slot.hostname, slot.local_rank), 0)

    d = drv_mod.ElasticDriver(
        rendezvous, _Sequence(*sets),
        sett.ElasticSettings(min_np=min_np, max_np=max_np,
                             elastic_timeout=5.0, discovery_interval=0.01),
        create_worker_fn=worker)
    d.start(np_)
    assert d.wait(10)
    return (sorted(seen), d.error, sorted(d.get_results().items()),
            rendezvous.round, rendezvous.world)


@pytest.mark.parametrize("name", sorted(DRIVER_SCRIPTS))
def test_driver_rounds_match_reference(name):
    got, want = _drive(PORT, name), _drive(JAX, name)
    assert got == want


def test_driver_preempt_drain_matches_reference():
    out = []
    for mods in (PORT, JAX):
        disc, drv_mod, _, sett, http = mods
        hold = threading.Event()
        d = drv_mod.ElasticDriver(
            _rendezvous(http),
            disc.FixedHostDiscovery({"h1": 1, "h2": 1}),
            sett.ElasticSettings(min_np=1, max_np=2, elastic_timeout=5.0,
                                 discovery_interval=0.01),
            create_worker_fn=lambda slot: hold.wait(5) and 0)
        d.start(2)
        body = json.dumps({"reason": "signal:15", "graceful": True}).encode()
        d._on_kv_put("failure", "h2/preempt", body)
        first = sorted(s.hostname for s in d._update_host_assignments(2))
        d._on_kv_put("failure", "h1/preempt", body)
        second = sorted(s.hostname for s in d._update_host_assignments(2))
        out.append((first, second, d.host_manager.is_blacklisted("h2")))
        hold.set()
        d.stop()
    assert out[0] == out[1]


def test_driver_aborts_the_dead_workers_peers():
    """A worker of the current round exits non-zero: every other
    registered worker gets ``PUT /abort`` for that round before the exit
    counts; the dead worker itself is not called."""
    got = {}

    class Recorder(notification.WorkerNotificationManager):
        def __init__(self, name):
            super().__init__()
            self.name = name

        def handle_abort(self, reason, elastic_round=None):
            got[self.name] = (reason, elastic_round)
            return True

    rendezvous = _rendezvous(http_server)
    d = driver.ElasticDriver(
        rendezvous, discovery.FixedHostDiscovery({"h": 3}),
        settings.ElasticSettings(min_np=1, max_np=3, elastic_timeout=5.0))
    d.start(3)
    managers = {}
    for slot in range(3):
        managers[slot] = Recorder(f"h/{slot}")
        managers[slot].start_server()
        rendezvous.store.put("workers", f"h/{slot}", json.dumps(
            {"host": "127.0.0.1", "port": managers[slot].port}).encode())
    d._handle_worker_exit("h", 1, -9)
    assert sorted(got) == ["h/0", "h/2"]
    assert all(r == rendezvous.round == 1 and "exited with -9" in reason
               for reason, r in got.values())
    d._handle_worker_exit("h", 0, 0)          # a clean exit aborts no one
    assert sorted(got) == ["h/0", "h/2"]
    d.stop()


def _non_loopback_ipv4():
    """An IPv4 address of one of this host's interfaces outside 127/8, read
    from the interface table (nothing is sent), or None."""
    import fcntl
    import socket
    import struct

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _, name in socket.if_nameindex():
            try:
                raw = fcntl.ioctl(s.fileno(), 0x8915,      # SIOCGIFADDR
                                  struct.pack("256s", name.encode()[:15]))
            except OSError:
                continue
            ip = socket.inet_ntoa(raw[20:24])
            if not ip.startswith("127."):
                return ip
    return None


def test_worker_on_another_host_registers_a_routable_address(monkeypatch):
    """A worker that reaches the driver's rendezvous over a non-loopback
    address (as one started over ssh does) serves and registers its
    notification server on this host's address on that route, and the
    driver's ``/abort`` and ``/notify`` reach it there."""
    ip = _non_loopback_ipv4()
    if ip is None:
        pytest.skip("this host has no IPv4 interface outside 127/8")
    assert notification.route_address("127.0.0.1:1") == "127.0.0.1"
    got = {}

    class Recorder(notification.WorkerNotificationManager):
        def handle_abort(self, reason, elastic_round=None):
            got.setdefault("abort", []).append(elastic_round)
            return True

        def handle_hosts_updated(self, timestamp, update_res):
            got.setdefault("notify", []).append(update_res)

    rendezvous = _rendezvous(http_server)
    port = rendezvous.start()
    d = driver.ElasticDriver(
        rendezvous, discovery.FixedHostDiscovery({"h": 2}),
        settings.ElasticSettings(min_np=1, max_np=2, elastic_timeout=5.0))
    try:
        d.start(2)
        monkeypatch.setenv("HVT_HOSTNAME", "h")
        monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "0")
        mgr = Recorder()
        mgr.init(f"{ip}:{port}")
        assert mgr.host == ip
        assert json.loads(rendezvous.store.get("workers", "h/0")) == {
            "host": ip, "port": mgr.port}
        assert d._worker_notify_addrs() == [f"{ip}:{mgr.port}"]
        d._handle_worker_exit("h", 1, -9)
        d._notify_workers_host_changes()
        assert got == {"abort": [rendezvous.round], "notify": [1]}
    finally:
        d.stop()
        rendezvous.stop()


def test_notification_abort_is_scoped_to_its_round():
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.common import basics

    mgr = notification.WorkerNotificationManager()
    mgr.start_server()

    class State:
        updates = []

        def on_hosts_updated(self, ts, res):
            self.updates.append(res)

    mgr.register_state(State())
    addr = f"127.0.0.1:{mgr.port}"
    old = os.environ.pop("HVT_ELASTIC_ROUND", None)
    os.environ["HVT_ELASTIC_ROUND"] = "4"
    try:
        hvt.init(device="cpu")
        http_client.put_json(addr, "/notify", {"timestamp": 1.0, "res": 1})
        assert State.updates == [1]
        http_client.put_json(addr, "/abort", {"round": 3, "reason": "old"})
        assert basics.aborted() is None       # another round's word
        http_client.put_json(addr, "/abort", {"round": 4, "reason": "dead"})
        assert basics.aborted() == "dead"
    finally:
        hvt.shutdown()
        os.environ.pop("HVT_ELASTIC_ROUND")
        if old is not None:
            os.environ["HVT_ELASTIC_ROUND"] = old


# ------------------------------------------------------- rendezvous server

def test_rendezvous_server_answers_as_the_reference():
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)

    answers = []
    for http in (http_server, jhttp):
        server = _rendezvous(http)
        port = server.start()
        addr = f"127.0.0.1:{port}"
        got = []
        try:
            for hosts, n in (("a:2,b:2", 4), ("b:1,a:2", 3)):
                server.init(get_host_assignments(parse_hosts(hosts), n))
                got.append(http_client.get_json(addr, "/world"))
                got.append(http_client.get_json(addr, "/rendezvous/a/1"))
                http_client.put_json(addr, "/kv/state/a/0", {"x": 1})
                http_client.put_json(addr, "/kv/workers/a/0", {"p": 2})
                got.append(http_client.get_json(addr, "/keys/state"))
                got.append(http_client.get_json(addr, "/kv/state/a/0"))
            for path in ("/rendezvous/zz/0", "/kv/state/none"):
                try:
                    http_client.get_json(addr, path, retries=0)
                except Exception as e:     # urllib's HTTPError
                    got.append(getattr(e, "code", None))
            import urllib.request

            urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/rendezvous", method="DELETE")).close()
            got.append(http_client.get_json(addr, "/keys/state"))
            got.append(http_client.get_json(addr, "/keys/workers"))
        finally:
            server.stop()
        answers.append(got)
    assert answers[0] == answers[1]


# -------------------------------------------------------------- launcher

def test_elastic_flags_parse_as_the_reference(tmp_path):
    argv = ["-np", "4", "--min-np", "2", "--max-np", "6",
            "--host-discovery-script", "./d.sh", "--reset-limit", "3",
            "--elastic-timeout", "30", "--slots", "2", "python", "t.py"]
    got, want = launch.parse_args(argv), jlaunch.parse_args(argv)
    for key in ("num_proc", "min_np", "max_np", "host_discovery_script",
                "reset_limit", "elastic_timeout", "slots", "command"):
        assert getattr(got, key) == getattr(want, key), key
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("min-np: 3\nslots: 4\n")
    got = launch.parse_args(["--config-file", str(cfg), "-np", "4", "x"])
    assert (got.min_np, got.slots) == (3, 4)


def test_each_round_gets_its_own_store_port():
    import socket

    port = launch.round_master_port("localhost", 1, 29510)
    with socket.socket() as s:      # probed free on this host
        s.bind(("", port))
    assert [launch.round_master_port("far-host", r, 29510)
            for r in (1, 2, 2049)] == [29511, 29512, 29511]


# ------------------------------------------------------------- preemption

def test_preemption_reports_as_the_reference(monkeypatch):
    """A notice flags every watched state and PUTs the same two reports to
    the driver's rendezvous as the JAX package's watcher."""
    from horovod_tpu.elastic import ObjectState as JObjectState
    from horovod_tpu.elastic import preemption as jpre
    from horovod_tpu_torch.elastic import ObjectState, preemption

    reports = []
    for pre, state_cls in ((preemption, ObjectState), (jpre, JObjectState)):
        server = _rendezvous(http_server)
        seen = []
        server.set_put_hook(lambda scope, key, v, seen=seen:
                            seen.append((scope, key,
                                         sorted(json.loads(v)))))
        port = server.start()
        monkeypatch.setenv("HVT_RENDEZVOUS_ADDR", f"127.0.0.1:{port}")
        monkeypatch.setenv("HVT_HOSTNAME", "hx")
        monkeypatch.setenv("HVT_LOCAL_PROCESS_ID", "2")
        state = state_cls(epoch=0)
        w = pre.PreemptionWatcher()
        w.watch(state)
        w.trigger("signal:15")
        server.stop()
        reports.append((seen, w.triggered, bool(state._host_messages)))
    assert reports[0] == reports[1]
    assert [s[:2] for s in reports[0][0]] == [("preempt", "hx/2"),
                                              ("failure", "hx/preempt")]


def test_sigterm_becomes_hosts_updated_at_the_next_commit():
    from horovod_tpu_torch.elastic import ObjectState, preemption

    state = ObjectState(epoch=0)
    w = preemption.PreemptionWatcher()
    w.watch(state)
    w.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not w.triggered and time.time() < deadline:
            time.sleep(0.01)
        import horovod_tpu_torch as hvt

        with pytest.raises(hvt.HostsUpdatedInterrupt):
            state.commit()
        state.commit()      # consumed
    finally:
        w.uninstall()


# ------------------------------------------------- launched gloo gangs

def _analysis(tmp_path, name):
    """One launched gang of JOBS, run to its end (at most JOB_TIMEOUT s)."""
    n, args = JOBS[name]
    job = EW.ElasticLaunch(n, str(tmp_path / name), args, min_np=2,
                           timeout=JOB_TIMEOUT)
    try:
        lives, rounds, _ = job.results()
    finally:
        job.kill()
    return lives, EW.analyze(lives, rounds)


def _one_process_step(before, batches, grad_scale=1.0):
    """One step of the shrink job's GPT and AdamW from the state dicts
    ``before``, in this process alone (no horovod_tpu_torch world): the
    gradient is the mean of those of ``batches`` (lists of rows of its
    dataset), each taken alone as a rank takes its own (the GPT computes
    in bf16, whose rounding depends on the batch's shape), times
    ``grad_scale``."""
    import torch

    from horovod_tpu_torch.models import GPT as TorchGPT
    from horovod_tpu_torch.models import GPTConfig
    from horovod_tpu_torch.train import loss_fn

    cfg = GPTConfig(**GPT)
    n, args = JOBS["shrink"]
    data = torch.from_numpy(EW.dataset(cfg, args["rows"], 0))
    model = TorchGPT(cfg, device="cpu", seed=1)
    model.load_state_dict(before[0])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    # a copy: the optimizer takes the state's tensors as they are, and its
    # step would update ``before`` in place
    opt.load_state_dict(copy.deepcopy(before[1]))
    for rows in batches:
        loss_fn(model, data[rows]).backward()
    for p in model.parameters():
        p.grad.mul_(grad_scale / len(batches))
    opt.step()
    return model.state_dict(), opt.state_dict()


def _flat(state):
    """Every tensor of ``(model_sd, optim_sd)`` as one fp64 vector."""
    import torch

    model_sd, optim_sd = state
    ts = [model_sd[k] for k in sorted(model_sd)]
    for i in sorted(optim_sd["state"]):
        s = optim_sd["state"][i]
        ts += [s[k] for k in sorted(s)]
    return torch.cat([t.double().reshape(-1) for t in ts]).numpy()


def test_launched_gang_loses_a_worker_and_finishes_at_size_2(tmp_path):
    import numpy as np

    lives, a = _analysis(tmp_path, "shrink")
    assert a["round_sizes"] == [3, 2]
    assert a["round_ranks"][1] == {"localhost/0": 0, "localhost/1": 1}
    assert a["devices_by_slot"] == {0: ["cpu"], 1: ["cpu"], 2: ["cpu"]}
    assert sorted(a["committed_counts"]) == list(range(48))
    assert set(a["committed_counts"].values()) == {1}
    assert sorted(a["kill_to_internal_error_s"]) == [0, 1]
    assert all(s < 30 for s in a["kill_to_internal_error_s"].values())
    assert a["restored_equals_commit"] == {0: True, 1: True}
    assert all(a["params_agree"].values()) and a["losses_finite"]
    done = [life for life in lives if "final_params_digest" in life]
    assert sorted(life["slot"] for life in done) == [0, 1]
    assert len({life["final_params_digest"] for life in done}) == 1
    assert all(life["final_processed"] == list(range(48)) for life in done)
    assert all(r["trigger"] == "failure" and set(r["phases"]) == {
        "abort", "restore", "shutdown", "rendezvous", "reinit", "rebuild"}
        for life in done for r in life["recoveries"])
    assert a["opt_set_sizes_match"]
    # the first step at size 2 against one process that takes the
    # restored commit through the same step on both survivors' rows
    steps = sorted((life["restored_step"] for life in done),
                   key=lambda r: r["rank"])
    assert [(r["rank"], r["size"]) for r in steps] == [(0, 2), (1, 2)]
    before = steps[0]["before"]
    assert _flat(steps[1]["before"]).tolist() == _flat(before).tolist()
    batches = [r["idx"] for r in steps]
    want = _flat(_one_process_step(before, batches))
    # a gradient averaged over the world before the shrink (3 ranks)
    stale = _flat(_one_process_step(before, batches, grad_scale=2 / 3))
    tol = dict(rtol=1e-5, atol=1e-7)
    assert not np.allclose(stale, want, **tol)
    for r in steps:
        np.testing.assert_allclose(_flat(r["after"]), want, **tol)


def test_launched_gang_shrinks_then_grows_back(tmp_path):
    lives, a = _analysis(tmp_path, "grow")
    assert a["round_sizes"][:2] == [3, 2] and a["round_sizes"][-1] == 3
    assert sorted(a["committed_counts"]) == list(range(153))
    assert set(a["committed_counts"].values()) == {1}
    assert all(a["params_agree"].values()), a["params_agree"]
    assert a["opt_set_sizes_match"]
    assert a["restored_equals_commit"] == {0: True, 1: True}
    fresh = [life for life in lives if life["slot"] == 2
             and "killed_digest" not in life]
    assert len(fresh) == 1
    done = [life for life in lives if "final_params_digest" in life]
    assert len(done) == 3
    assert len({life["final_params_digest"] for life in done}) == 1


def test_launched_gang_respawns_and_rebuilds_from_a_peer_shard(tmp_path):
    lives, a = _analysis(tmp_path, "replicated")
    assert a["round_sizes"] == [4, 4]
    assert a["fresh_equals_killed"]
    assert a["fresh_last_recovery"]["outcome"] == "peer"
    assert sorted(a["kill_to_internal_error_s"]) == [0, 1, 2]
    assert all(a["params_agree"].values()) and a["losses_finite"]
    done = [life for life in lives if "final_params_digest" in life]
    assert len(done) == 4
    assert len({life["final_params_digest"] for life in done}) == 1
