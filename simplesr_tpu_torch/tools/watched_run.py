"""Stall watchdog for long runs on the card: runs a command, appends its
output to a log, and kills and retries it (a bounded number of times)
whenever the log stays silent longer than ``--stall-seconds``; the
counterpart of scripts/watched_run.py, standard library only.

A long CUDA run can stop making progress without exiting: a collective
that waits for a rank that died, a hung data-loader worker, a device fault
that leaves the process blocked in a CUDA call. The process then uses no
CPU and writes nothing. A wall-clock limit is the wrong tool (a healthy
campaign runs for hours); output silence while the process is alive is the
signature. Exit status is the command's own when it ends, 124 when every
attempt stalled.

    python -m simplesr_tpu_torch.tools.watched_run --stall-seconds 1080 \
        --retries 2 --log runs/stage.log -- \
        python -m simplesr_tpu_torch.tools.quality_campaign --scale 4

Notes:
  - the stall threshold must exceed the longest silent stretch of a healthy
    run: the first call that builds the CUDA kernels (``nvcc``, seconds to a
    minute), cuDNN's first plans at a new shape, a validation pass or a
    checkpoint that prints nothing;
  - the child is its own process group, so a kill takes its data-loader
    workers and other helper processes with it;
  - retries help only against transient stalls; a fault that persists stalls
    the next attempt too, which is why attempts are bounded (resume from the
    last checkpoint with ``--resume`` where the command supports it).
"""

import argparse
import os
import signal
import subprocess
import sys
import time


def _kill_group(proc, grace=10.0):
    """SIGTERM the child's process group, escalate to SIGKILL after `grace`
    seconds (without waiting it out if the child dies sooner)."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.monotonic() + grace
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.2)
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def run_once(cmd, log_path, stall_seconds, poll=10.0):
    """One attempt: returns the exit code, or None if killed for stalling."""
    # Children that write to a file (not a tty) block-buffer stdout (~8 KB);
    # a healthy run printing short progress lines would look silent for
    # hours. Force line-at-a-time output for Python children — the log's
    # growth IS the liveness signal.
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(log_path, "ab", buffering=0) as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env)
        try:
            last_size, last_change = -1, time.monotonic()
            while True:
                rc = proc.poll()
                if rc is not None:
                    return rc
                size = os.path.getsize(log_path)
                now = time.monotonic()
                if size != last_size:
                    last_size, last_change = size, now
                elif now - last_change > stall_seconds:
                    sys.stderr.write(
                        f"[watched_run] no output for "
                        f"{int(now - last_change)}s — killing pid "
                        f"{proc.pid}\n")
                    _kill_group(proc)
                    try:
                        # a child blocked in an uninterruptible CUDA call can
                        # survive SIGKILL until the call returns; don't
                        # let it block the watchdog too
                        proc.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        sys.stderr.write(
                            f"[watched_run] pid {proc.pid} unkillable "
                            "(blocked in a CUDA call?) — abandoning it\n")
                    return None
                time.sleep(poll)
        finally:
            # wrapper interrupted/killed: don't leave the (possibly wedged)
            # child holding the device — it's in its own session, so the
            # terminal's SIGINT never reaches it
            if proc.poll() is None:
                _kill_group(proc)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stall-seconds", type=float, default=1080,
                   help="kill the command after this much output silence")
    p.add_argument("--retries", type=int, default=2,
                   help="extra attempts after a stalled one")
    p.add_argument("--log", required=True,
                   help="file receiving the command's stdout+stderr "
                        "(appended; its growth is the liveness signal)")
    p.add_argument("--poll", type=float, default=10.0,
                   help="seconds between liveness checks")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- command to run")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command given (use: python -m simplesr_tpu_torch.tools.watched_run [opts] -- cmd ...)")
    if args.stall_seconds <= 0:
        p.error("--stall-seconds must be positive")

    for attempt in range(1 + max(0, args.retries)):
        if attempt:
            sys.stderr.write(f"[watched_run] retry {attempt}\n")
        rc = run_once(cmd, args.log, args.stall_seconds, args.poll)
        if rc is not None:
            return rc
    sys.stderr.write("[watched_run] all attempts stalled\n")
    return 124


if __name__ == "__main__":
    raise SystemExit(main())
