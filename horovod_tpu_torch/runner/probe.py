"""The launcher's pre-flight probe across hosts (Horovod's
``runner/driver/driver_service.py:162`` ``_driver_fn`` and
``runner/task_fn.py:23``; the JAX package's ``runner/probe.py``). Before a
job that spans hosts starts, a small task service runs on every host; each
tells the launcher its host hash and its interfaces' addresses, then tries
the next host's addresses in a ring, so that one-way or NAT'ed interfaces
drop out, and the launcher takes the rendezvous address from what the ring
could reach (:func:`rendezvous_address`).

Every message is signed with the job's secret key (HMAC-SHA256 in the
``X-HVT-Digest`` header); a service answers an unsigned or changed one
with 403.

``python -m horovod_tpu_torch.runner.probe serve --index I`` runs one
task service (the key in ``HVT_PROBE_KEY``, hex) and prints
``HVT_PROBE_PORT=<port>`` once it listens; it stops when its standard
input closes.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from horovod_tpu_torch.runner import network, secret


class _SignedHandler(BaseHTTPRequestHandler):
    key: bytes = b""

    def _read_signed(self) -> Optional[dict]:
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        try:
            digest = bytes.fromhex(self.headers.get("X-HVT-Digest", ""))
        except ValueError:
            digest = b""    # a malformed digest fails like a wrong one
        if not secret.check_digest(self.key, body, digest):
            self.send_response(403)
            self.end_headers()
            return None
        return json.loads(body)

    def _send_json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _signed_request(addr: str, path: str, obj: dict, key: bytes,
                    timeout: float = 5.0) -> dict:
    import urllib.request

    body = json.dumps(obj).encode()
    req = urllib.request.Request(
        f"http://{addr}{path}", data=body, method="PUT",
        headers={"X-HVT-Digest": secret.compute_digest(key, body).hex()})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        data = resp.read()
        return json.loads(data) if data else {}


class TaskService:
    """Runs on each host of the job; answers ``info`` and ``probe``."""

    def __init__(self, index: int, key: bytes, salt: str = ""):
        self._index = index
        self._key = key
        self._salt = salt
        self._server = None
        self.port = None

    def start(self) -> int:
        svc = self

        class Handler(_SignedHandler):
            key = svc._key

            def do_PUT(self):
                msg = self._read_signed()
                if msg is None:
                    return
                if msg.get("cmd") == "info":
                    from horovod_tpu_torch.runner.host_hash import host_hash

                    self._send_json({
                        "index": svc._index,
                        "host_hash": host_hash(svc._salt),
                        "addresses": network.local_addresses(),
                        "interfaces": network.get_local_interfaces(),
                    })
                elif msg.get("cmd") == "probe":
                    ok = network.probe_reachable(
                        msg["addresses"], int(msg["port"]),
                        timeout=float(msg.get("timeout", 2.0)))
                    self._send_json({"reachable": ok})
                else:
                    self._send_json({"error": "unknown cmd"}, 400)

        self._server = ThreadingHTTPServer(("0.0.0.0", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self.port

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class DriverProbe:
    """The launcher's side: given the task services' addresses, collect
    each host's information and run the ring probe."""

    def __init__(self, key: bytes):
        self._key = key

    def collect_info(self, task_addrs: List[str]) -> List[dict]:
        return [_signed_request(a, "/", {"cmd": "info"}, self._key)
                for a in task_addrs]

    def ring_probe(self, task_addrs: List[str],
                   infos: List[dict]) -> Dict[str, List[str]]:
        """Task i tries task i+1's addresses on i+1's service port; the
        addresses that answered, keyed by the probed task's index."""
        n = len(task_addrs)
        out: Dict[str, List[str]] = {}
        for i in range(n):
            nxt = (i + 1) % n
            port = int(task_addrs[nxt].rsplit(":", 1)[1])
            resp = _signed_request(
                task_addrs[i], "/",
                {"cmd": "probe", "addresses": infos[nxt]["addresses"],
                 "port": port}, self._key)
            out[str(nxt)] = resp.get("reachable", [])
        return out

    def common_interfaces(self, task_addrs: List[str]) -> List[str]:
        """The interface names usable on every host: an interface counts
        for a host when one of its addresses answered the previous host in
        the ring (Horovod's ``get_common_interfaces``)."""
        infos = self.collect_info(task_addrs)
        links = self.ring_probe(task_addrs, infos)
        per_host_nics = {}
        for idx_str, reachable in links.items():
            info = infos[int(idx_str)]
            per_host_nics[idx_str] = {
                name for name, ips in info["interfaces"].items()
                if any(ip in reachable for ip in ips)}
        sets = list(per_host_nics.values())
        return sorted(set.intersection(*sets)) if sets else []

    def reachable_addresses(self, task_addrs: List[str]
                            ) -> Dict[str, List[str]]:
        """Each host's addresses that its ring neighbour reached, keyed by
        task index: what the rendezvous can advertise for it."""
        infos = self.collect_info(task_addrs)
        return self.ring_probe(task_addrs, infos)


def wait_for_service(addr: str, timeout: float = 30.0) -> bool:
    host, port = addr.rsplit(":", 1)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if network.can_connect(host, int(port), timeout=1.0):
            return True
        time.sleep(0.2)
    return False


def _ssh_service(host, index, key, ssh_port):
    """A task service started on ``host`` over ssh, and its address."""
    remote = (f"cd {shlex.quote(os.getcwd())} && env "
              f"HVT_PROBE_KEY={key.hex()} {shlex.quote(sys.executable)} -m "
              f"horovod_tpu_torch.runner.probe serve --index {index}")
    proc = subprocess.Popen(
        ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(ssh_port), host,
         remote], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("HVT_PROBE_PORT="):
        proc.kill()
        raise RuntimeError(f"the probe service on {host} did not start")
    return proc, f"{host}:{line.split('=', 1)[1]}"


def rendezvous_address(hosts: List[str], is_local, ssh_port: int = 22,
                       timeout: float = 30.0) -> str:
    """The address of ``hosts[0]`` (the coordinator's host) that the ring
    of task services, one a host, reached: a task service runs in this
    process for a local host and over ssh for a remote one, all signed
    with a fresh key. Raises when no address of it answered."""
    key = secret.make_secret_key()
    local, procs, addrs = [], [], []
    try:
        for i, host in enumerate(hosts):
            if is_local(host):
                svc = TaskService(i, key)
                local.append(svc)
                addrs.append(f"127.0.0.1:{svc.start()}")
            else:
                proc, addr = _ssh_service(host, i, key, ssh_port)
                procs.append(proc)
                addrs.append(addr)
        for addr in addrs:
            if not wait_for_service(addr, timeout):
                raise RuntimeError(f"probe service {addr} did not answer")
        reached = DriverProbe(key).reachable_addresses(addrs)["0"]
    finally:
        for svc in local:
            svc.stop()
        for proc in procs:
            proc.stdin.close()
            proc.wait(timeout=10)
    usable = [a for a in reached if not a.startswith("127.")]
    if not usable:
        raise RuntimeError(f"no address of {hosts[0]} answered the probe "
                           f"from {hosts[-1]}: {reached}")
    return usable[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "horovod_tpu_torch.runner.probe")
    sub = p.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="run one task service")
    serve.add_argument("--index", type=int, required=True)
    a = p.parse_args(argv)
    svc = TaskService(a.index, bytes.fromhex(os.environ["HVT_PROBE_KEY"]))
    print(f"HVT_PROBE_PORT={svc.start()}", flush=True)
    sys.stdin.read()     # until the launcher closes it
    svc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
