"""Fault tolerance for long-running jobs.

The port of ``repro.train.fault_tolerance``, its logic unchanged.
``ResilientTrainer`` wraps a step function with:

* periodic (async) checkpointing + automatic restore-from-latest on restart
  or on a step failure (retry budget, exponential backoff), and a final
  blocking save;
* a ``StragglerWatchdog`` that tracks per-step wall time and flags steps
  exceeding ``k×`` the running median (a callback would feed the
  controller that replaces the slow host; here it records them);
* a failure-injection hook the tests use to simulate preemptions.

Data-pipeline resume is exact because the pipeline is stateless in `step`
(see data.pipeline): restoring `step` restores sample order.  A step that
updates the state in place (``make_train_step(donate=True)``) and fails
inside the update leaves it half-updated and raises
``PartialUpdateError``: the trainer retries it only from a checkpoint,
whose restore replaces the whole state, and re-raises when there is none
(the reference's retry reruns the step on its intact input state, which a
donating step no longer has).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable, Optional

from .checkpoint import CheckpointManager
from .optimizer import PartialUpdateError

log = logging.getLogger("repro_torch.fault_tolerance")


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float = 3.0
    window: int = 32
    min_samples: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=64))
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float):
        if len(self._times) >= self.min_samples:
            med = sorted(self._times)[len(self._times) // 2]
            if seconds > self.factor * med:
                self.flagged.append((step, seconds, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, med)
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self._times.append(seconds)


@dataclasses.dataclass
class ResilientTrainer:
    step_fn: Callable                     # (state, batch) -> (state, metrics)
    batch_fn: Callable                    # step:int -> batch
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_retries: int = 3
    async_ckpt: bool = True
    watchdog: StragglerWatchdog = dataclasses.field(
        default_factory=StragglerWatchdog)
    failure_injector: Optional[Callable[[int], None]] = None

    def run(self, state, start_step: int, num_steps: int,
            state_template=None, device=None):
        """Run ``num_steps`` steps with restart-on-failure.  Returns
        (final_state, metrics_history).  A restore puts the state on
        ``device`` (default: the template's devices)."""
        template = state_template if state_template is not None else state
        latest = self.ckpt.latest_step()
        if latest is not None and latest >= start_step:
            state = self.ckpt.restore(latest, template, device)
            start_step = latest
            log.info("resumed from checkpoint step %d", latest)
        history = []
        step = start_step
        retries = 0
        while step < start_step + num_steps:
            try:
                if self.failure_injector:
                    self.failure_injector(step)
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                # reading the metrics waits for the device, so a step's
                # seconds include its device work
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                history.append({"step": step, "seconds": dt, **metrics})
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, {"step": step},
                                   blocking=not self.async_ckpt)
            except Exception as exc:   # noqa: BLE001 — restart-on-any-failure
                retries += 1
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None and isinstance(exc, PartialUpdateError):
                    raise       # the state is half-updated: nothing to retry
                log.warning("step %d failed (%s); restoring (retry %d/%d)",
                            step, exc, retries, self.max_retries)
                time.sleep(min(2.0 ** retries * 0.01, 1.0))
                if latest is not None:
                    state = self.ckpt.restore(latest, template, device)
                    step = latest
        self.ckpt.wait()
        self.ckpt.save(step, state, {"step": step}, blocking=True)
        return state, history
