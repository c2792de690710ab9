"""``hvt_top`` — live terminal monitor for a running gang of the port
(``python -m horovod_tpu_torch.tools.hvt_top --addr HOST:PORT``): the
port's copy of the JAX package's ``tools/hvt_top.py``.

Renders the ``GET /statusz`` gang rollup of the port's KV server
(``runner/http_server.py`` → ``metrics/telemetry.py``: the launcher's with
``--timeline``, or the elastic rendezvous) as a one-screen view: a
rank-health grid, active health alerts (a stalled negotiation among
them), the straggler ranking, byte rates, the wire codecs, and the serving
backlog. The port has no engine links, so the grid's ``r`` never shows.

Curses-free: plain ANSI clear-and-redraw, so it works over ssh, tmux or a
CI log, and appends frames with ``--no-clear``. For scripts:

    python -m horovod_tpu_torch.tools.hvt_top --addr H:P --once --json

prints exactly one raw ``/statusz`` JSON document and exits 0, or exits 2
when the server cannot be reached.

Rank-grid legend: ``.`` ok · ``q`` queued work · ``s`` stale pushes ·
``r`` link reconnecting · ``b`` broken (sticky abort) · ``!`` named in
an active alert · ``_`` expected but never reported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

GRID_COLS = 32


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024.0
    return "?"


def rank_cell(rank: int, rec, alert_ranks) -> str:
    """One grid character for a rank (see module legend)."""
    if rec is None:
        return "_"
    if rank in alert_ranks:
        return "!"
    if rec.get("broken"):
        return "b"
    if rec.get("stale"):
        return "s"
    if rec.get("links", {}).get("reconnecting") or \
            rec.get("links", {}).get("dead"):
        return "r"
    if rec.get("queue_depth", 0) or rec.get("pending", 0):
        return "q"
    return "."


def render(statusz: dict, now_str: str = None) -> str:
    """Pure statusz → screen text (unit-testable; no I/O)."""
    s = statusz
    w = s.get("world") or {}
    lines = []
    lines.append(
        f"hvt_top — {s.get('ranks_covered', 0)}/{s.get('ranks_expected', 0)}"
        f" ranks, {len(s.get('hosts') or {})} host frame(s), "
        f"round {s.get('round')}, mode {s.get('mode')}"
        + (f" — {now_str}" if now_str else ""))
    hosts_n = len(w.get("hosts") or ())
    if hosts_n:
        lines.append(f"world: size {w.get('size')} over {hosts_n} "
                     f"host(s), master {w.get('master_host')}")
    rates = s.get("rates") or {}
    if rates.get("window_sec"):
        lines.append(
            f"rates ({rates['window_sec']}s window): "
            f"ctrl {_fmt_bytes(rates.get('ctrl_bytes_per_sec'))}/s · "
            f"wire {_fmt_bytes(rates.get('wire_bytes_per_sec'))}/s · "
            f"EF resident {_fmt_bytes(rates.get('ef_residual_bytes'))}")
    codecs = s.get("codecs") or {}
    if codecs.get("intra") or codecs.get("inter"):
        lines.append(f"codecs: intra {','.join(codecs.get('intra') or ['-'])}"
                     f" · inter {','.join(codecs.get('inter') or ['-'])}"
                     f" · reconnects {s.get('reconnect_total', 0)}")

    # rank grid
    expected = int(s.get("ranks_expected") or 0)
    recs = {int(r): rec for r, rec in (s.get("ranks") or {}).items()}
    n = max(expected, max(recs) + 1 if recs else 0)
    alert_ranks = set()
    for a in s.get("alerts") or ():
        subj = str(a.get("subject", ""))
        if subj.startswith("rank "):
            try:
                alert_ranks.add(int(subj.split()[1]))
            except ValueError:
                pass
    if n:
        lines.append("ranks (.=ok q=queued s=stale r=reconn b=broken "
                     "!=alert _=missing):")
        for base in range(0, n, GRID_COLS):
            cells = "".join(
                rank_cell(r, recs.get(r), alert_ranks)
                for r in range(base, min(base + GRID_COLS, n)))
            lines.append(f"  {base:>5}  {cells}")

    alerts = s.get("alerts") or []
    lines.append(f"alerts: {len(alerts)} active"
                 if alerts else "alerts: none")
    for a in alerts:
        lines.append(f"  [{a.get('severity', '?')}] {a.get('rule')}: "
                     f"{a.get('detail')}")
    stragglers = s.get("stragglers") or []
    if stragglers:
        top = ", ".join(
            f"rank {d['rank']} ({d['windows']} win)"
            for d in stragglers[:5])
        lines.append(f"stragglers: {top}")
    serving = s.get("serving") or {}
    if serving.get("ranks") or serving.get("stale_ranks"):
        # stale entries (dead/shed ranks whose final push is aging out
        # of the swept KV) are shown as stale, never as live lanes
        stale = serving.get("stale_ranks", 0)
        lines.append(
            f"serving: {serving.get('ranks', 0)} rank(s)"
            + (f" (+{stale} stale)" if stale else "")
            + f", backlog max {serving.get('inflight_max', 0)}, sheds "
            f"{serving.get('shed_total', 0)}")
        lanes = serving.get("lanes") or {}
        if lanes:
            row = ", ".join(
                f"lane {lid}: p99 {d.get('p99_ms_max', 0):.1f}ms "
                f"bkl {d.get('inflight_max', 0)}"
                for lid, d in sorted(
                    lanes.items(),
                    key=lambda kv: (0, int(kv[0]))
                    if str(kv[0]).lstrip("-").isdigit()
                    else (1, str(kv[0])))[:6])
            lines.append(f"  {row}")
    missing = s.get("missing_ranks") or []
    if missing:
        shown = ",".join(str(r) for r in missing[:16])
        more = f" (+{len(missing) - 16})" if len(missing) > 16 else ""
        lines.append(f"missing ranks: {shown}{more}")
    return "\n".join(lines) + "\n"


def fetch(addr: str, timeout: float = 5.0) -> dict:
    from horovod_tpu_torch.runner.http_client import get_json

    return get_json(addr, "/statusz", timeout=timeout, retries=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.hvt_top",
        description="live gang health monitor over GET /statusz "
                    "(elastic rendezvous / launch --timeline KV server)")
    ap.add_argument("--addr", required=True,
                    help="rendezvous server host:port")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the raw /statusz JSON instead of the "
                         "screen (with --once: the CI round-trip)")
    ap.add_argument("--no-clear", action="store_true",
                    help="append frames instead of ANSI clear-redraw")
    args = ap.parse_args(argv)

    while True:
        try:
            statusz = fetch(args.addr)
        except Exception as e:
            print(f"hvt_top: cannot reach {args.addr}/statusz: {e}",
                  file=sys.stderr)
            return 2
        if not isinstance(statusz, dict):
            print(f"hvt_top: {args.addr}/statusz returned no document",
                  file=sys.stderr)
            return 2
        if args.as_json:
            out = json.dumps(statusz, indent=None, sort_keys=True)
        else:
            out = render(statusz, time.strftime("%H:%M:%S"))
        if not (args.once or args.no_clear or args.as_json):
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(out if out.endswith("\n") else out + "\n")
        sys.stdout.flush()
        if args.once:
            return 0
        time.sleep(max(0.2, args.interval))


if __name__ == "__main__":
    sys.exit(main())
