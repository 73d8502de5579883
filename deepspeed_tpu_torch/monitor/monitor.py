"""Experiment monitoring.

Counterpart of ``deepspeed_tpu/monitor/monitor.py`` (reference
deepspeed/monitor/: the ``Monitor`` ABC, monitor.py:13, and ``MonitorMaster``,
:29, fanning out to TensorBoard / W&B / CSV writers).  Events are
``(tag, value, step)`` triples; only rank 0 writes.  A writer whose package
is missing disables itself with a warning, as in the JAX package.
"""

import csv
import logging
import os
from typing import List, Tuple

logger = logging.getLogger(__name__)

Event = Tuple[str, float, int]


def process_rank() -> int:
    """This process's rank: ``torch.distributed``'s once it is initialized,
    else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Monitor:

    def write_events(self, events: List[Event]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """``torch.utils.tensorboard.SummaryWriter`` when tensorboard is
    installed, else disabled."""

    def __init__(self, config):
        self.enabled = False
        self.summary_writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            path = os.path.join(config.output_path or "runs", config.job_name)
            self.summary_writer = SummaryWriter(log_dir=path)
            self.enabled = True
        except Exception as e:
            logger.warning(f"TensorBoard monitor disabled: {e}")

    def write_events(self, events: List[Event]):
        if not self.enabled:
            return
        for tag, value, step in events:
            self.summary_writer.add_scalar(tag, value, step)
        self.summary_writer.flush()


class WandbMonitor(Monitor):

    def __init__(self, config):
        self.enabled = False
        try:
            import wandb  # type: ignore
            wandb.init(project=config.project, group=config.group, entity=config.team)
            self._wandb = wandb
            self.enabled = True
        except Exception as e:
            logger.warning(f"W&B monitor disabled: {e}")

    def write_events(self, events: List[Event]):
        if not self.enabled:
            return
        for tag, value, step in events:
            self._wandb.log({tag: value}, step=step)


class csvMonitor(Monitor):
    """CSV writer (reference monitor/csv_monitor.py): one file per tag."""

    def __init__(self, config):
        self.output_path = os.path.join(config.output_path or "csv_logs", config.job_name)
        os.makedirs(self.output_path, exist_ok=True)
        self.enabled = True

    def write_events(self, events: List[Event]):
        for tag, value, step in events:
            fname = os.path.join(self.output_path, tag.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as fh:
                w = csv.writer(fh)
                if new:
                    w.writerow(["step", tag])
                w.writerow([step, value])


class MonitorMaster(Monitor):
    """Fan-out (reference monitor/monitor.py:29); rank 0 only."""

    def __init__(self, training_config):
        self.monitors: List[Monitor] = []
        if process_rank() != 0:
            return
        mc = training_config.monitor_config
        tb = mc.tensorboard if mc else training_config.tensorboard
        wb = mc.wandb if mc else training_config.wandb
        cv = mc.csv_monitor if mc else training_config.csv_monitor
        if tb.enabled:
            self.monitors.append(TensorBoardMonitor(tb))
        if wb.enabled:
            self.monitors.append(WandbMonitor(wb))
        if cv.enabled:
            self.monitors.append(csvMonitor(cv))

    @property
    def enabled(self):
        return bool(self.monitors)

    def write_events(self, events: List[Event]):
        for m in self.monitors:
            m.write_events(events)
