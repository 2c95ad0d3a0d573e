"""The training loop with fault-tolerance hooks: checkpoint and restart,
heartbeat, straggler detection (the counterpart of `repro.train.trainer`).

    while step < total:
        batch   = pipeline.batch_at(step)       # deterministic, seekable
        state   = train_step(state, batch)
        monitor.beat(self_node, step)           # dead / straggler sets into metrics
        if step % ckpt_every or the last step:  -> async atomic checkpoint
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..ckpt.checkpoint import DEFAULT_DIR, CheckpointManager
from ..data.pipeline import SyntheticTokenPipeline
from ..ft.heartbeat import HeartbeatMonitor
from .optimizer import OptState, init_opt_state


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = str(DEFAULT_DIR)
    self_node: int = 0


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        params,
        pipeline: SyntheticTokenPipeline,
        cfg: TrainerConfig,
        monitor: Optional[HeartbeatMonitor] = None,
        ckpt: Optional[CheckpointManager] = None,
        opt_state: Optional[OptState] = None,
    ):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state if opt_state is not None else init_opt_state(params)
        self.pipeline = pipeline
        self.cfg = cfg
        self.monitor = monitor
        self.ckpt = ckpt or CheckpointManager(cfg.ckpt_dir)
        self.step = 0
        self.history: list[dict] = []

    # ---------------------------------------------------------- restart
    def maybe_resume(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        (self.params, self.opt_state), extra = self.ckpt.restore(
            (self.params, self.opt_state))
        self.step = int(extra["step"])
        return True

    # -------------------------------------------------------------- run
    def run(self, on_step: Optional[Callable] = None) -> list[dict]:
        c = self.cfg
        while self.step < c.total_steps:
            t0 = time.monotonic()
            batch = self.pipeline.batch_at(self.step)
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            self.step += 1

            if self.monitor is not None:
                self.monitor.beat(c.self_node, self.step)
                dead = self.monitor.check_dead()
                strag = self.monitor.check_stragglers()
                if dead:
                    metrics = {**metrics, "dead_nodes": sorted(dead)}
                if strag:
                    metrics = {**metrics, "stragglers": sorted(strag)}

            if self.step % c.ckpt_every == 0 or self.step == c.total_steps:
                self.ckpt.save(self.step, (self.params, self.opt_state),
                               extra={"step": self.step})

            if self.step % c.log_every == 0 or self.step == c.total_steps:
                rec = {
                    "step": self.step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "dt_s": time.monotonic() - t0,
                }
                self.history.append(rec)
                if on_step:
                    on_step(rec)
        self.ckpt.wait()
        return self.history
