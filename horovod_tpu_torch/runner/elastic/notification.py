"""Worker-side notifications from the elastic driver: the port's copy of
the JAX package's ``runner/elastic/notification.py`` (Horovod's
``runner/elastic/worker.py:37`` WorkerNotificationManager).

Each elastic worker runs a small HTTP server and registers it with the
driver's rendezvous (``/kv/workers/<host>/<slot>``). The driver PUTs

- ``/notify`` on a host-set change: every registered State gets
  ``on_hosts_updated``, so the next ``state.commit()`` raises
  HostsUpdatedInterrupt;
- ``/abort`` when it saw a worker of the current round die: the handler
  calls ``basics.abort`` (for that round only), which tears down the
  process group so that a collective blocked on the dead peer returns and
  the worker's next collective or commit raises HorovodInternalError. On
  NCCL this is how a survivor learns of the death: the blocked collective
  would otherwise wait for the process group's timeout.

Neither handler calls a collective. Outside an elastic launch (no
``HVT_ELASTIC_NOTIFY_ADDR``) the manager is inert.

The server listens on this host's address on the route to the driver, and
registers that address: loopback when the driver runs on the same host,
the interface that reaches the driver's host when the worker was started
over ssh.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_manager = None
_lock = threading.Lock()


class WorkerNotificationManager:
    def __init__(self):
        self._states = []
        self._server = None
        self._host = self._port = None

    def register_state(self, state):
        self._states.append(state)

    def remove_state(self, state):
        if state in self._states:
            self._states.remove(state)

    @property
    def host(self):
        return self._host

    @property
    def port(self):
        return self._port

    def handle_hosts_updated(self, timestamp, update_res):
        for s in list(self._states):
            s.on_hosts_updated(timestamp, update_res)

    def handle_abort(self, reason, elastic_round=None) -> bool:
        from horovod_tpu_torch.common import basics

        return basics.abort(reason, elastic_round=elastic_round)

    def start_server(self, host="127.0.0.1"):
        """Serve on ``host`` (an address of this host), on a free port."""
        mgr = self

        class Handler(BaseHTTPRequestHandler):
            def do_PUT(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if self.path.rstrip("/") == "/abort":
                    # before the reply: the driver counts the dead
                    # worker's exit only once the survivors were told
                    mgr.handle_abort(body.get("reason", "a peer died"),
                                     body.get("round"))
                else:
                    mgr.handle_hosts_updated(
                        body.get("timestamp", time.time()),
                        body.get("res", 0))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self._server = ThreadingHTTPServer((host, 0), Handler)
        self._host, self._port = self._server.server_address[:2]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def init(self, rendezvous_addr=None):
        """Start the server and register it with the elastic driver's
        rendezvous (``host:port``) so it can notify us (Horovod's
        ``worker.py:44-66``)."""
        from horovod_tpu_torch.runner.http_client import put_json

        addr = rendezvous_addr or os.environ["HVT_ELASTIC_NOTIFY_ADDR"]
        self.start_server(route_address(addr))
        # keyed by the stable spawn identity (host, local_rank), not rank:
        # ranks reshuffle across rounds, and a rank-keyed entry would let a
        # new worker overwrite a live survivor's
        host = os.environ.get("HVT_HOSTNAME") or socket.gethostname()
        slot = os.environ.get("HVT_LOCAL_PROCESS_ID", "0")
        put_json(addr, f"/kv/workers/{host}/{slot}",
                 {"host": self._host, "port": self._port})


def route_address(addr) -> str:
    """This host's IPv4 address on the route to ``addr`` (``host:port``).
    Connecting a UDP socket only picks the route: it sends nothing."""
    host, port = addr.rsplit(":", 1)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, int(port)))
        return s.getsockname()[0]


def init_worker_notification(state):
    """Called by ``@hvt.elastic.run``: start the manager once and register
    the state. Inert outside an elastic launch."""
    global _manager
    with _lock:
        if _manager is None:
            _manager = WorkerNotificationManager()
            if os.environ.get("HVT_ELASTIC_NOTIFY_ADDR"):
                _manager.init()
        _manager.register_state(state)
    return _manager
