"""Starting ranks without ``torchrun``: one subprocess per rank, joined
through a file.

``spawn(argv, world, init_file)`` starts ``world`` copies of ``argv`` with
``RANK``, ``WORLD_SIZE`` and ``REPRO_INIT_FILE`` in their environment and
waits for all of them; ``init_rank(backend)`` is what each copy calls
first: it joins the group by ``init_method="file://<init_file>"`` (no TCP
port to collide with a neighbour's) and pins one CPU thread per rank.  Use
``gloo`` where the ranks share one card or run on the CPU (NCCL refuses
two ranks on one device) and NCCL where each rank has its own card, which
``torchrun`` does as well.
"""

from __future__ import annotations

import os
import subprocess
import time


def init_rank(backend: str = "gloo") -> tuple[int, int]:
    """Join the group this process was spawned into; -> (rank, world)."""
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.environ["REPRO_INIT_FILE"],
        rank=rank, world_size=world)
    return rank, world


def spawn(argv: list[str], world: int, init_file: str, *,
          timeout: float = 600.0, env: dict | None = None
          ) -> list[subprocess.CompletedProcess]:
    """Run ``argv`` (e.g. ``[sys.executable, "-c", script]``) as ``world``
    ranks; every rank's completed process, in rank order.  Ranks still
    running at ``timeout`` seconds are killed (their return code is then
    negative) so no process outlives the call."""
    if os.path.exists(init_file):
        os.remove(init_file)
    procs = []
    for rank in range(world):
        penv = dict(os.environ if env is None else env, RANK=str(rank),
                    WORLD_SIZE=str(world), REPRO_INIT_FILE=init_file)
        procs.append(subprocess.Popen(argv, env=penv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    done = []
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(1.0, deadline
                                                 - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        done.append(subprocess.CompletedProcess(argv, p.returncode, out, err))
    return done
