"""Worker bootstrap: runs inside every launched worker before the user
script (counterpart of ``paddle_tpu/distributed/launch/bootstrap.py``).

It writes the worker's first heartbeat before anything heavy is
imported, so the launcher's hang watchdog never mistakes a long start-up
for a wedged worker, then runs the script as ``__main__``. It imports no
``torch`` and joins no process group: ``torch.distributed`` has no rule
that the group exist before the backend is touched, so a worker joins in
its own ``init_parallel_env(...)`` call, which reads the launcher's env
contract. A worker that shards only data never calls it and trains as a
world of one (so ``PADDLE_SKIP_DIST_INIT``, which the reference's
bootstrap reads, has nothing to skip here).
"""

from __future__ import annotations

import runpy
import sys


def main():
    from . import heartbeat

    heartbeat.write(step=None)
    script = sys.argv[1]
    sys.argv = sys.argv[1:]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
