"""Production-run supervisor: liveness + automatic checkpoint resume.

A production process that dies mid-run must not go unnoticed (a stale
``run.pid`` and a half-finished posterior).  This wrapper owns the run
lifecycle:

* launches the inversion command, appending stdout/stderr to ``<dir>/run.log``;
* maintains ``<dir>/run.pid`` (written on spawn, removed on exit — no stale
  pids);
* on a non-zero exit (device fault, OOM, lost host) restarts the command
  with ``--resume`` as long as the checkpoint file exists, up to
  ``--max-restarts`` times with a backoff;
* exits 0 only when the supervised command itself completed.

The reference has no equivalent (a lost Julia worker kills the run,
SURVEY.md §5 failure detection); per-chain cputime bookkeeping is the
closest analogue (HMCSampler.jl:813).

Usage:
    python scripts/supervise.py --dir runs/myrun \
        --checkpoint runs/myrun/checkpoint.npz -- \
        python -c '...' / hmcmt2d run startupfile --checkpoint ... [args]

Everything after ``--`` is the command; ``--resume`` is appended on
restarts (the driver's resume path is bit-exact, sampler/checkpoint.py).
"""

import argparse
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="run directory (log + pid)")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint path gating restart-with-resume")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--backoff", type=float, default=15.0,
                    help="seconds to wait before a restart")
    ap.add_argument("--resume-flag", default="--resume")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (append it after --)")

    os.makedirs(args.dir, exist_ok=True)
    log_path = os.path.join(args.dir, "run.log")
    pid_path = os.path.join(args.dir, "run.pid")

    attempt = 0
    while True:
        full = list(cmd)
        resumed = False
        if attempt > 0 and args.checkpoint and os.path.exists(args.checkpoint):
            full.append(args.resume_flag)
            resumed = True
        with open(log_path, "a") as log:
            log.write(f"\n[supervise] attempt {attempt} "
                      f"({'resume' if resumed else 'fresh'}) "
                      f"{time.strftime('%Y-%m-%d %H:%M:%S')}: "
                      f"{' '.join(full)}\n")
            log.flush()
            proc = subprocess.Popen(full, stdout=log,
                                    stderr=subprocess.STDOUT)
            with open(pid_path, "w") as f:
                f.write(f"{proc.pid}\n")
            try:
                rc = proc.wait()
            except KeyboardInterrupt:
                proc.terminate()
                rc = proc.wait()
                log.write(f"[supervise] interrupted; child exited {rc}\n")
                _cleanup(pid_path)
                return 130
            log.write(f"[supervise] attempt {attempt} exited rc={rc} "
                      f"{time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        _cleanup(pid_path)
        if rc == 0:
            print(f"[supervise] run completed (attempt {attempt})")
            return 0
        attempt += 1
        if attempt > args.max_restarts:
            print(f"[supervise] giving up after {args.max_restarts} restarts "
                  f"(last rc={rc})", file=sys.stderr)
            return rc or 1
        if args.checkpoint and not os.path.exists(args.checkpoint):
            print(f"[supervise] rc={rc} and no checkpoint yet — restarting "
                  f"fresh", file=sys.stderr)
        time.sleep(args.backoff)


def _cleanup(pid_path):
    try:
        os.remove(pid_path)
    except OSError:
        pass


if __name__ == "__main__":
    sys.exit(main())
