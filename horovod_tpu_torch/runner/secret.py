"""HMAC signing of the launcher's control messages (Horovod's
``runner/common/util/secret.py``; the JAX package's ``runner/secret.py``).
The launcher makes one key per job; the probe's services refuse a payload
that is unsigned or was changed."""

from __future__ import annotations

import hashlib
import hmac
import os

DIGEST = hashlib.sha256


def make_secret_key() -> bytes:
    return os.urandom(32)


def compute_digest(secret_key: bytes, payload: bytes) -> bytes:
    return hmac.new(secret_key, payload, DIGEST).digest()


def check_digest(secret_key: bytes, payload: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(compute_digest(secret_key, payload), digest)
