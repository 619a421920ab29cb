"""Node-local launcher (reference: ``launcher/launch.py:133`` main —
spawns one proc per GPU, sets RANK env, signal handling,
``terminate_process_tree`` :119).

Counterpart of ``deepspeed_tpu/launcher/launch.py``.  One process runs per
host, as in the JAX package: this module reads the coordinator env set by
the runner, joins the ``torch.distributed`` group
(:func:`init_distributed_from_env`: ``tcp://`` + ``DSPD_COORDINATOR``,
world size ``DSPD_NUM_PROCESSES``, the resolved rank; the backend left to
torch's device map, NCCL for CUDA tensors and gloo for CPU ones) and
execs the user script in-process.  Signal handling forwards SIGTERM/SIGINT
to the child process group when the script is run as a subprocess
(``--as_subprocess``).
"""

from __future__ import annotations

import os
import runpy
import signal
import subprocess
import sys
from typing import List, Optional

from ..utils.logging import logger


def terminate_process_tree(proc: subprocess.Popen) -> None:
    """(reference: launch.py:119) — SIGTERM the child's process group,
    SIGKILL after a grace period."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def resolve_process_id() -> int:
    """Rank resolution order: explicit DSPD_PROCESS_ID (ssh/local
    runners) > SLURM_PROCID (srun) > position of this hostname in
    DSPD_HOSTS (pdsh broadcast, which can't set per-host env)."""
    pid = os.environ.get("DSPD_PROCESS_ID")
    if pid is not None:
        return int(pid)
    slurm = os.environ.get("SLURM_PROCID")
    if slurm is not None:
        return int(slurm)
    hosts = os.environ.get("DSPD_HOSTS", "")
    if hosts:
        import socket
        names = hosts.split(",")
        me = socket.gethostname()
        for i, h in enumerate(names):
            if h == me or h == me.split(".")[0] or me.startswith(h + "."):
                return i
        raise RuntimeError(f"hostname {me!r} not in DSPD_HOSTS={hosts!r}")
    return 0


def init_distributed_from_env() -> None:
    """Wire DSPD_* env (set by the runner) into torch.distributed: the
    coordinator as a ``tcp://`` rendezvous, the backend unset (torch's
    device -> backend map: NCCL for CUDA tensors, gloo for CPU ones)."""
    coord = os.environ.get("DSPD_COORDINATOR")
    if not coord:
        return
    import torch.distributed as dist

    pid = resolve_process_id()
    world = int(os.environ.get("DSPD_NUM_PROCESSES", "1"))
    dist.init_process_group(init_method="tcp://" + coord, world_size=world,
                            rank=pid)
    logger.info("torch.distributed up: process %s/%s via %s (%s)", pid,
                world, coord, dist.get_backend_config())


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_subprocess = "--as_subprocess" in argv
    if as_subprocess:
        argv.remove("--as_subprocess")
    if not argv:
        print(  # tpulint: disable=print — CLI usage text
            "usage: python -m deepspeed_tpu_torch.launcher.launch script.py ...",
            file=sys.stderr)
        return 2
    script, *script_args = argv

    if as_subprocess:
        proc = subprocess.Popen([sys.executable, script, *script_args],
                                start_new_session=True)

        def handler(signum, frame):
            terminate_process_tree(proc)
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
        return proc.wait()

    init_distributed_from_env()
    sys.argv = [script, *script_args]
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
