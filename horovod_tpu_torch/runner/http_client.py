"""Tiny HTTP KV client: the port's copy of the JAX package's
``runner/http_client.py`` (Horovod's ``runner/http/http_client.py``).

All three verbs are idempotent against the rendezvous KV (PUTs replace a
key, GETs read one), so transient transport failures — a connection
refused while the server is still binding, a reset mid-rendezvous, a
socket timeout — are retried with bounded exponential backoff + jitter
instead of killing the worker. HTTP errors below 500 (e.g. the 404 that
elastic workers poll through) are the server speaking and are never
retried; 5xx and OS-level errors are.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

# bounded backoff: first retry after ~0.1 s, doubling to a 2 s cap, with
# full jitter so a gang of workers hammering a restarting rendezvous
# server decorrelates instead of thundering
DEFAULT_RETRIES = 4
_BACKOFF_BASE = 0.1
_BACKOFF_CAP = 2.0


def _urlopen_retrying(req, timeout, retries):
    delay = _BACKOFF_BASE
    for attempt in range(retries + 1):
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            # the server answered: 4xx is a real answer (elastic workers
            # poll through 404s), 5xx is transient server trouble
            if e.code < 500 or attempt >= retries:
                raise
        except OSError:
            # URLError (connection refused/reset) and socket.timeout
            # both subclass OSError
            if attempt >= retries:
                raise
        # 50-100% jitter: decorrelates a worker gang without collapsing
        # the backoff to near-zero (the retry budget stays predictable)
        time.sleep(delay * (0.5 + 0.5 * random.random()))
        delay = min(delay * 2, _BACKOFF_CAP)


def put_json(addr, path, obj, timeout=5, retries=DEFAULT_RETRIES):
    data = json.dumps(obj).encode()
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method="PUT",
                                 headers={"Content-Type":
                                          "application/json"})
    with _urlopen_retrying(req, timeout, retries) as resp:
        return resp.status


def get_json(addr, path, timeout=5, retries=DEFAULT_RETRIES):
    req = urllib.request.Request(f"http://{addr}{path}")
    with _urlopen_retrying(req, timeout, retries) as resp:
        body = resp.read()
        return json.loads(body) if body else None


def put_bytes(addr, path, data: bytes, timeout=5, retries=DEFAULT_RETRIES):
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method="PUT",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    with _urlopen_retrying(req, timeout, retries) as resp:
        return resp.status
