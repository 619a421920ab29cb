"""Multi-host launcher — the ``deepspeed`` CLI analog.

Counterpart of ``deepspeed_tpu/launcher/runner.py``, copied (pure
Python): the hostfile, ``--include`` / ``--exclude``, the local, SSH, PDSH
and Slurm runners and the ``--elastic_training`` restart loop.  As in the
JAX package, one process runs per host; its node command runs
``python -m deepspeed_tpu_torch.launcher.launch`` with the ``DSPD_*``
environment, which joins the ``torch.distributed`` group and execs the
script once.  "slots" count a host's local devices only for bookkeeping
(per-GPU ranks come with the multi-GPU slice).

CLI::

    python -m deepspeed_tpu_torch.launcher.runner \
        --hostfile hosts.txt --include "worker-[0-3]" train.py --args...
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger

DEFAULT_COORD_PORT = 29500


# --------------------------------------------------------------------------
# hostfile (reference: launcher/runner.py:210 parse_resource_filter et al.)
# --------------------------------------------------------------------------

def parse_hostfile(text: str) -> "OrderedDict[str, int]":
    """``hostname slots=N`` per line; '#' comments
    (reference: runner.py fetch_hostfile)."""
    hosts: "OrderedDict[str, int]" = OrderedDict()
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        m = re.match(r"^(\S+)(?:\s+slots=(\d+))?$", line)
        if m is None:
            raise ValueError(f"bad hostfile line: {line!r}")
        hosts[m.group(1)] = int(m.group(2) or 1)
    if not hosts:
        raise ValueError("hostfile is empty")
    return hosts


def _expand_brackets(pat: str) -> List[str]:
    """worker-[0-3] -> worker-0..worker-3 (pdsh-style ranges)."""
    m = re.match(r"^(.*)\[(\d+)-(\d+)\](.*)$", pat)
    if not m:
        return [pat]
    pre, lo, hi, post = m.groups()
    return [f"{pre}{i}{post}" for i in range(int(lo), int(hi) + 1)]


def parse_inclusion_exclusion(hosts: "OrderedDict[str, int]",
                              include: str = "",
                              exclude: str = "") -> "OrderedDict[str, int]":
    """Filter hosts (reference: runner.py:265 parse_resource_filter).

    Syntax: ``host1@host2`` or ranges ``worker-[0-3]``; ``host:0,1``
    selects local device slots on that host.
    """
    if include and exclude:
        raise ValueError("--include and --exclude are mutually exclusive")

    def parse(sel: str) -> Dict[str, Optional[List[int]]]:
        out: Dict[str, Optional[List[int]]] = {}
        for term in sel.split("@"):
            term = term.strip()
            if not term:
                continue
            if ":" in term:
                name, slots = term.split(":")
                idx = [int(s) for s in slots.split(",")]
            else:
                name, idx = term, None
            for h in _expand_brackets(name):
                out[h] = idx
        return out

    if include:
        sel = parse(include)
        result: "OrderedDict[str, int]" = OrderedDict()
        for h, idx in sel.items():
            if h not in hosts:
                raise ValueError(f"include host {h!r} not in hostfile")
            result[h] = len(idx) if idx is not None else hosts[h]
        return result
    if exclude:
        sel = parse(exclude)
        result = OrderedDict()
        for h, n in hosts.items():
            if h in sel:
                idx = sel[h]
                if idx is None:
                    continue                       # whole host excluded
                left = n - len(idx)
                if left > 0:
                    result[h] = left
            else:
                result[h] = n
        if not result:
            raise ValueError("--exclude removed every host")
        return result
    return hosts


# --------------------------------------------------------------------------
# runners (reference: launcher/multinode_runner.py PDSH/MPI/SLURM variants)
# --------------------------------------------------------------------------

class MultiNodeRunner:
    """Builds the per-job command; subclasses differ in transport."""

    name = "base"

    def __init__(self, args, hosts: "OrderedDict[str, int]"):
        self.args = args
        self.hosts = hosts
        self.exports: Dict[str, str] = {}

    def add_export(self, key: str, value: str) -> None:
        self.exports[key] = str(value)

    @property
    def coordinator(self) -> str:
        host = self.args.master_addr or next(iter(self.hosts))
        return f"{host}:{self.args.master_port}"

    def node_cmd(self, host: str, rank: int) -> List[str]:
        """Command run on one host (process_id = host rank; rank=-1 means
        the node derives it itself from DSPD_HOSTS/SLURM_PROCID)."""
        env = dict(self.exports)
        env["DSPD_COORDINATOR"] = self.coordinator
        env["DSPD_NUM_PROCESSES"] = str(len(self.hosts))
        if rank >= 0:
            env["DSPD_PROCESS_ID"] = str(rank)
        exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        script = " ".join([shlex.quote(self.args.user_script),
                           *map(shlex.quote, self.args.user_args)])
        return ["bash", "-c",
                f"cd {shlex.quote(os.getcwd())} && env {exports} "
                f"{sys.executable} -m deepspeed_tpu_torch.launcher.launch {script}"]

    def launch_cmds(self) -> List[Tuple[str, List[str]]]:
        return [(h, self._wrap(h, self.node_cmd(h, i)))
                for i, h in enumerate(self.hosts)]

    def _wrap(self, host: str, cmd: List[str]) -> List[str]:
        raise NotImplementedError


class LocalRunner(MultiNodeRunner):
    """Single host, no ssh (reference: runner.py local fallback)."""
    name = "local"

    def _wrap(self, host, cmd):
        return cmd


class SSHRunner(MultiNodeRunner):
    """Plain ssh per host (reference: PDSHRunner's transport, pdsh-free)."""
    name = "ssh"

    def _wrap(self, host, cmd):
        return ["ssh", "-o", "StrictHostKeyChecking=no", host,
                " ".join(shlex.quote(c) for c in cmd)]


class PDSHRunner(MultiNodeRunner):
    """(reference: multinode_runner.py:51 PDSHRunner).

    pdsh broadcasts ONE command to every host, so the per-host rank
    cannot ride the env: instead DSPD_HOSTS carries the ordered host
    list and launch.py derives process_id from the local hostname."""
    name = "pdsh"

    def launch_cmds(self):
        hostlist = ",".join(self.hosts)
        self.add_export("DSPD_HOSTS", hostlist)
        cmd = self.node_cmd(hostlist, rank=-1)   # rank resolved on-node
        quoted = " ".join(shlex.quote(c) for c in cmd)
        return [(hostlist, ["pdsh", "-S", "-w", hostlist, quoted])]


class SlurmRunner(MultiNodeRunner):
    """(reference: multinode_runner.py SlurmRunner via srun).  Rank comes
    from SLURM_PROCID on each task (read by launch.py)."""
    name = "slurm"

    def launch_cmds(self):
        n = len(self.hosts)
        cmd = self.node_cmd(next(iter(self.hosts)), rank=-1)
        return [("slurm", ["srun", f"--nodes={n}", f"--ntasks={n}",
                           "--ntasks-per-node=1"] + cmd)]


RUNNERS = {c.name: c for c in (LocalRunner, SSHRunner, PDSHRunner,
                               SlurmRunner)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch",
        description="multi-host launcher (deepspeed CLI analog)")
    p.add_argument("--hostfile", type=str, default="")
    p.add_argument("--include", type=str, default="")
    p.add_argument("--exclude", type=str, default="")
    p.add_argument("--num_nodes", type=int, default=-1)
    p.add_argument("--master_addr", type=str, default="")
    p.add_argument("--master_port", type=int, default=DEFAULT_COORD_PORT)
    p.add_argument("--launcher", type=str, default="ssh",
                   choices=sorted(RUNNERS))
    p.add_argument("--force_multi", action="store_true")
    # elastic agent (reference: elasticity/elastic_agent.py:32
    # DSElasticAgent; runner.py:383 --elastic_training): when any node
    # process dies, the whole worker group is torn down and relaunched —
    # the training script resumes from its latest (universal) checkpoint
    p.add_argument("--elastic_training", "--elastic", action="store_true",
                   dest="elastic_training")
    p.add_argument("--max_elastic_restarts", type=int, default=100)
    p.add_argument("user_script", type=str)
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p


def _run_group(runner: MultiNodeRunner) -> int:
    """Launch one worker group and babysit it: returns 0 when every node
    process exits clean; on the FIRST failure the surviving processes are
    torn down (the reference agent's stop-workers step) and the failing
    rc is returned."""
    import time as _time

    procs = [subprocess.Popen(cmd) for _, cmd in runner.launch_cmds()]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            bad = [rc for rc in rcs if rc not in (None, 0)]
            if bad:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    p.wait()
                return bad[0]
            if all(rc == 0 for rc in rcs):
                return 0
            _time.sleep(0.2)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()
        raise


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = parse_hostfile(f.read())
    else:
        hosts = OrderedDict([("localhost", 1)])
    hosts = parse_inclusion_exclusion(hosts, args.include, args.exclude)
    if args.num_nodes > 0:
        hosts = OrderedDict(list(hosts.items())[:args.num_nodes])

    if len(hosts) == 1 and not args.force_multi:
        runner: MultiNodeRunner = LocalRunner(args, hosts)
    else:
        runner = RUNNERS[args.launcher](args, hosts)
    logger.info("launching on %d host(s) via %s: %s",
                len(hosts), runner.name, list(hosts))

    if not args.elastic_training:
        procs = [subprocess.Popen(cmd)
                 for _, cmd in runner.launch_cmds()]
        rc = 0
        try:
            for p in procs:
                rc = p.wait() or rc
        except KeyboardInterrupt:
            for p in procs:
                p.terminate()
            rc = 1
        return rc
    try:
        # elastic: relaunch the worker group until it exits clean or the
        # restart budget runs out (reference: DSElasticAgent._invoke_run
        # monitor/restart loop); resumption happens inside the user
        # script via its latest checkpoint
        attempt = 0
        while True:
            rc = _run_group(runner)
            if rc == 0:
                return 0
            attempt += 1
            if attempt > args.max_elastic_restarts:
                logger.error("elastic: restart budget exhausted "
                             "(%d); giving up with rc=%d",
                             args.max_elastic_restarts, rc)
                return rc
            logger.warning("elastic: worker group failed (rc=%d); "
                           "restart %d/%d", rc, attempt,
                           args.max_elastic_restarts)
    except KeyboardInterrupt:
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
