"""Experiment monitoring: fan-out scalar/event writers.

Copied from the JAX package's ``monitor/monitor.py``, the counterpart of
the reference monitor subsystem
(``monitor/monitor.py:30`` ``MonitorMaster`` fanning out to
TensorBoard/WandB/Comet/CSV writers in ``monitor/{tensorboard,wandb,
comet,csv_monitor}.py``; engine scalar events ``runtime/engine.py:2317``).

Only rank 0 of ``torch.distributed`` writes (rank 0 when no process
group is initialised; the reference gates on rank, monitor/monitor.py):
every rank sees the same reduced metrics, so one writer suffices.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.logging import logger

def _rank() -> int:
    """This process's ``torch.distributed`` rank, 0 when no process group
    is initialised (torch imported here: a writer-less caller never
    pays for it)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


# (name, value, step) triples — the reference's event tuple shape
Event = Tuple[str, float, int]


class Monitor:
    """Writer interface (reference: monitor/monitor.py Monitor ABC)."""

    def __init__(self, config):
        self.enabled = bool(getattr(config, "enabled", False))

    def write_events(self, events: Sequence[Event]) -> None:
        raise NotImplementedError

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self.write_events([(k, float(v), step) for k, v in scalars.items()])

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class CSVMonitor(Monitor):
    """One CSV file per metric name (reference: monitor/csv_monitor.py)."""

    def __init__(self, config):
        super().__init__(config)
        base = config.output_path or "csv_monitor"
        self.dir = os.path.join(base, config.job_name)
        os.makedirs(self.dir, exist_ok=True)
        self._files: Dict[str, Any] = {}

    def _writer(self, name: str):
        if name not in self._files:
            safe = name.replace("/", "_")
            f = open(os.path.join(self.dir, f"{safe}.csv"), "a", newline="")
            self._files[name] = (f, csv.writer(f))
        return self._files[name]

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            f, w = self._writer(name)
            w.writerow([step, value])
            f.flush()          # rows visible immediately (tail -f etc.)

    def flush(self) -> None:
        for f, _ in self._files.values():
            f.flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            f.close()
        self._files = {}


class TensorBoardMonitor(Monitor):
    """(reference: monitor/tensorboard.py — SummaryWriter wrapper)."""

    def __init__(self, config):
        super().__init__(config)
        from torch.utils.tensorboard import SummaryWriter  # torch is baked in

        path = os.path.join(config.output_path or "runs", config.job_name)
        self.writer = SummaryWriter(log_dir=path)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            self.writer.add_scalar(name, value, step)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class WandbMonitor(Monitor):
    """(reference: monitor/wandb.py)."""

    def __init__(self, config):
        super().__init__(config)
        import wandb  # optional; gated by caller

        self.wandb = wandb
        wandb.init(project=config.project, group=config.group,
                   entity=config.team)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            self.wandb.log({name: value}, step=step)

    def close(self) -> None:
        self.wandb.finish()


class CometMonitor(Monitor):
    """(reference: monitor/comet.py CometMonitor — Experiment wrapper
    honoring samples_log_interval; comet_ml is an optional dependency,
    gated by MonitorMaster exactly like wandb)."""

    def __init__(self, config):
        super().__init__(config)
        import comet_ml  # optional; gated by caller

        kw = {k: v for k, v in dict(
            api_key=config.api_key, project_name=config.project,
            workspace=config.workspace,
            experiment_key=config.experiment_key or None).items()
            if v}
        if config.online:
            self.experiment = comet_ml.Experiment(**kw)
        else:
            self.experiment = comet_ml.OfflineExperiment(**kw)
        if config.experiment_name:
            self.experiment.set_name(config.experiment_name)
        self.samples_log_interval = max(1, config.samples_log_interval)

    def write_events(self, events: Sequence[Event]) -> None:
        for name, value, step in events:
            if step % self.samples_log_interval == 0:
                self.experiment.log_metric(name, value, step=step)

    def close(self) -> None:
        self.experiment.end()


class MonitorMaster(Monitor):
    """Builds every enabled writer and fans events out
    (reference: monitor/monitor.py:30)."""

    def __init__(self, config):
        # `config` is the top-level framework Config (or anything with
        # .tensorboard/.csv_monitor/.wandb sub-configs)
        self.writers: List[Monitor] = []
        self.enabled = False
        if _rank() != 0:
            return
        specs = [
            (getattr(config, "csv_monitor", None), CSVMonitor),
            (getattr(config, "tensorboard", None), TensorBoardMonitor),
            (getattr(config, "wandb", None), WandbMonitor),
            (getattr(config, "comet", None), CometMonitor),
        ]
        for sub, cls in specs:
            if sub is None or not sub.enabled:
                continue
            try:
                self.writers.append(cls(sub))
            except Exception as e:  # missing optional dep — warn, continue
                logger.warning("monitor writer %s disabled (%s)",
                               cls.__name__, e)
        self.enabled = bool(self.writers)

    def write_events(self, events: Sequence[Event]) -> None:
        for w in self.writers:
            w.write_events(events)

    def flush(self) -> None:
        for w in self.writers:
            w.flush()

    def close(self) -> None:
        for w in self.writers:
            w.close()
