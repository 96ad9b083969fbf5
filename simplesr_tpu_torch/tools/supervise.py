"""Crash supervisor for long training runs, as simplesr_tpu.tools.supervise.

    python -m simplesr_tpu_torch.tools.supervise <config.yaml> \\
        [--max-restarts N] [--backoff SECONDS] [--device cpu]

Runs ``python -m simplesr_tpu_torch.tools.train <config.yaml>`` (with
``--device`` when it is given) as a child process and, when the child
crashes (a nonzero exit other than the preemption code), restarts it with
``--resume``: the per-epoch resume point means a crash loses at most one
epoch.

Exit semantics:
  * child exits 0 (training complete)        -> supervisor exits 0;
  * child exits 75 (preempted via SIGTERM)   -> supervisor exits 75: the
    host is going away; the next invocation resumes;
  * child crashes                            -> restart with --resume, up
    to --max-restarts, then exit with the child's last code.

SIGTERM and SIGINT to the supervisor go on to the child (so that the
child's preemption path runs), and the supervisor exits with the child's
code without restarting.

``--cmd`` replaces the training command (an argv list; the supervisor
appends ``--resume`` on restarts), so that the restart logic can be tested
with any child.
"""

import argparse
import signal
import subprocess
import sys
import time

EXIT_PREEMPTED = 75


def _run_once(cmd):
    """Run the child, forwarding SIGTERM and SIGINT. Returns (rc,
    forwarded)."""
    child = subprocess.Popen(cmd)
    forwarded = {"flag": False}

    def handler(signum, _frame):
        forwarded["flag"] = True
        try:
            child.send_signal(signum)
        except OSError:
            pass

    prev = {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        rc = child.wait()
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)
    return rc, forwarded["flag"]


def supervise(cmd, max_restarts=10, backoff=10.0, log=print):
    """Run ``cmd`` until success or preemption, restarting crashes with
    ``--resume`` appended. Returns the final exit code."""
    attempt = 0
    current = list(cmd)
    while True:
        log(f"[supervise] attempt {attempt + 1}: {' '.join(current)}")
        rc, forwarded = _run_once(current)
        if rc == 0:
            log("[supervise] training complete")
            return 0
        if rc == EXIT_PREEMPTED or forwarded:
            log(f"[supervise] child stopped (rc={rc}, "
                f"signal_forwarded={forwarded}) - not restarting; "
                "rerun to resume")
            return rc
        attempt += 1
        if attempt > max_restarts:
            log(f"[supervise] child crashed (rc={rc}); restart budget "
                f"({max_restarts}) exhausted")
            return rc
        log(f"[supervise] child crashed (rc={rc}); restarting with "
            f"--resume in {backoff:g}s ({attempt}/{max_restarts})")
        time.sleep(backoff)
        if "--resume" not in current:
            current = current + ["--resume"]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Supervise a training run: restart crashes with --resume")
    p.add_argument("config", nargs="?", help="YAML config (ignored with --cmd)")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--backoff", type=float, default=10.0,
                   help="seconds between restarts")
    p.add_argument("--device", default=None,
                   help="passed on to the training child (cuda by default there)")
    p.add_argument("--cmd", nargs=argparse.REMAINDER, default=None,
                   help="override the child command (testing hook); "
                        "--resume is appended on restarts")
    args = p.parse_args(argv)
    if args.max_restarts < 0:
        p.error("--max-restarts must be >= 0")
    if args.backoff < 0:
        p.error("--backoff must be >= 0")
    if args.cmd:
        cmd = args.cmd
    elif args.config:
        from simplesr_tpu_torch.core.device import resolve_device

        resolve_device(args.device or "cuda")  # no card: raise now, not once per restart
        cmd = [sys.executable, "-m", "simplesr_tpu_torch.tools.train", args.config]
        if args.device:
            cmd += ["--device", args.device]
    else:
        p.error("a config YAML (or --cmd) is required")
    return supervise(cmd, max_restarts=args.max_restarts, backoff=args.backoff)


if __name__ == "__main__":
    sys.exit(main())
