"""Child process management: the port's own copy of the JAX package's
``runner/safe_exec.py`` (Horovod's ``runner/common/util/safe_shell_exec.py``:
fork + process-group kill, event-driven termination, stdout/err
forwarding, parent-death safety so a SIGKILLed launcher never leaks
workers)."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

_PR_SET_PDEATHSIG = 1  # linux/prctl.h

# Resolve libc at import time: preexec_fn runs between fork() and exec()
# where taking the import/allocator locks can deadlock a child forked
# from a multithreaded launcher (subprocess docs' preexec warning).
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None, use_errno=True)
    _libc.prctl  # resolve the symbol now, not post-fork
except Exception:  # pragma: no cover - non-linux
    _libc = None


def _child_preexec():
    """Runs in the forked child before exec: new session (own process
    group, so terminate() can killpg) + PDEATHSIG so the kernel delivers
    SIGTERM to the child if the launcher dies — including SIGKILL, which
    the launcher cannot catch to clean up itself (reference
    safe_shell_exec.py:60-140 achieves this with a middleman process;
    prctl covers the same contract without one). PR_SET_PDEATHSIG
    survives execve, so arbitrary worker commands are covered.

    Note: the kernel ties PDEATHSIG to the spawning THREAD — callers must
    spawn from a thread that outlives the child (run_all spawns from the
    main thread)."""
    os.setsid()
    if _libc is not None:
        _libc.prctl(_PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)


class Child:
    def __init__(self, cmd, env, tag=None, stdout=None):
        self.tag = tag
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, preexec_fn=_child_preexec)
        self._pump = threading.Thread(target=self._forward,
                                      args=(stdout or sys.stdout,),
                                      daemon=True)
        self._pump.start()

    def _forward(self, out):
        prefix = f"[{self.tag}] " if self.tag is not None else ""
        for line in iter(self.proc.stdout.readline, b""):
            try:
                out.write(prefix + line.decode(errors="replace"))
                out.flush()
            except ValueError:
                break

    def poll(self):
        return self.proc.poll()

    def terminate(self, grace_sec=5.0):
        """SIGTERM the whole process group, then SIGKILL stragglers —
        the reference's event-driven termination semantics."""
        if self.proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            return
        deadline = time.time() + grace_sec
        while time.time() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass

    def wait(self):
        rc = self.proc.wait()
        self._pump.join(timeout=2)
        return rc


def run_all(commands_envs_tags, on_first_failure_kill_rest=True):
    """Launch all children; wait; on first non-zero exit, terminate the
    rest (reference gloo_run.py:261-271 raises on first failure)."""
    children = [Child(cmd, env, tag) for cmd, env, tag in commands_envs_tags]
    exit_codes = [None] * len(children)
    try:
        pending = set(range(len(children)))
        while pending:
            for i in list(pending):
                rc = children[i].poll()
                if rc is not None:
                    exit_codes[i] = rc
                    pending.discard(i)
                    if rc != 0 and on_first_failure_kill_rest:
                        for j in pending:
                            children[j].terminate()
            time.sleep(0.05)
    except KeyboardInterrupt:
        for c in children:
            c.terminate()
        raise
    for i, c in enumerate(children):
        exit_codes[i] = c.wait() if exit_codes[i] is None else exit_codes[i]
    return exit_codes
