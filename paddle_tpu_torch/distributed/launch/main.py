"""Launcher CLI (counterpart of ``paddle_tpu/distributed/launch/main.py``).

Usage::

    python -m paddle_tpu_torch.distributed.launch \
        [--nnodes N] [--nproc_per_node M] [--master IP:PORT] \
        [--rank NODE_RANK] [--log_dir DIR] [--max_restart K] \
        [--devices 0,1,...] script.py [script args...]

Single node (default): picks a free local port for the rendezvous and
starts M workers. Multi-node: pass --master pointing at node 0 and
--rank for this node; every node runs the same command. Each worker joins
its process group by calling ``init_parallel_env`` itself.
"""

from __future__ import annotations

import argparse
import sys

from .controllers.collective import (CollectiveController, CrashLoopError,
                                     _free_port)

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint IP:PORT (node 0); "
                        "auto-selected for single-node jobs")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="workers per node (default: 1)")
    p.add_argument("--rank", "--node_rank", type=int, default=0,
                   dest="rank", help="this node's index in [0, nnodes)")
    p.add_argument("--log_dir", default=None,
                   help="write per-worker logs to DIR/workerlog.N")
    p.add_argument("--max_restart", type=int, default=0,
                   help="leaky-bucket restart budget: relaunch the whole "
                        "local group after a crash or hang up to K times "
                        "per FLAGS_restart_window_s rolling window, with "
                        "exponential backoff (FLAGS_restart_backoff_s). "
                        "Clean preemptions (a worker exiting 123 after a "
                        "graceful SIGTERM checkpoint) relaunch for free")
    p.add_argument("--devices", default=None,
                   help="comma list of local CUDA device ids to expose "
                        "(sets CUDA_VISIBLE_DEVICES per worker)")
    p.add_argument("training_script", help="script (or binary) to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.master_auto = False
    if args.master is None:
        if args.nnodes > 1:
            raise SystemExit(
                "--master IP:PORT is required for multi-node jobs "
                "(point every node at node 0)")
        # auto-selected master: the controller picks a fresh port each
        # restart round (master_auto), so a rendezvous never collides
        # with the dead round's TIME_WAIT socket
        args.master = f"127.0.0.1:{_free_port()}"
        args.master_auto = True
    elif ":" not in args.master or not args.master.rsplit(":", 1)[1].isdigit():
        raise SystemExit(
            f"--master must be IP:PORT, got {args.master!r}")
    ctrl = CollectiveController(args)
    try:
        return ctrl.run()
    except CrashLoopError as e:
        print(f"[launch] {e}", file=sys.stderr)
        return e.exit_code


if __name__ == "__main__":
    sys.exit(main())
