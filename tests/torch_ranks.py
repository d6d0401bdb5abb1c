"""Start the port's ranks for the multi-process ``test_torch_*`` files: one
``python -c`` worker per rank, joined over gloo on the CPU, as
``tests/test_multihost.py`` starts the JAX package's processes.  Each
worker gets the environment ``torchrun`` gives a rank (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), so it joins through ``distributed.initialize("cpu")`` as
a launched rank does.  A worker source reads the caller's arguments from
``sys.argv[1:]``, imports only ``torch`` and ``retinanet_tpu_torch``, and
writes what the test holds against JAX."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(source: str, *args: str, world: int = 2
                ) -> List[subprocess.Popen]:
    """Start ``world`` workers running ``source``, one host's ranks as
    ``torchrun --nproc-per-node world`` starts them; returns at once."""
    env = dict(os.environ, OMP_NUM_THREADS="2", WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    return [subprocess.Popen(
        [sys.executable, "-c", source, *map(str, args)],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def finish_ranks(procs: List[subprocess.Popen], timeout: float = 240
                 ) -> List[str]:
    """Each worker's output; fails if one failed or outlived ``timeout``
    (every worker is stopped either way)."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            raise AssertionError(f"a rank hung:\n{out[-3000:]}")
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs
