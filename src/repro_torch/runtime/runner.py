"""Fault-tolerant step runner: checkpoint/restart, failure injection,
resume.

Counterpart of ``repro/runtime/runner.py``.  The control loop a long run
needs, reduced to its testable core:

* periodic (optionally async) checkpoints of the state;
* on ANY step failure (preemption, hardware fault — injected in tests via
  ``failure_hook``), restore the latest valid checkpoint and replay: because
  the data stream is stateless in the step, replay is bit-deterministic;
* a bounded retry budget, then the failure surfaces.

It is free of device specifics: the checkpoint manager puts each restored
tensor back on the device the state lives on.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, Protocol

from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

log = logging.getLogger(__name__)


class StepStream(Protocol):
    """What the runner reads its batches from: ``(step, batch)`` pairs from
    ``start_step`` on, the same batch for the same step on every call."""

    def iterate(self, start_step: int) -> Iterator[tuple[int, object]]: ...


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    checkpoint_every: int = 50
    max_restarts: int = 3
    async_checkpoint: bool = True


class FaultTolerantRunner:
    def __init__(self, cfg: RunnerConfig, *, train_step: Callable,
                 data: StepStream, ckpt: CheckpointManager,
                 failure_hook: Callable[[int], None] | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.data = data
        self.ckpt = ckpt
        self.failure_hook = failure_hook
        self.restarts = 0
        self.metrics_history: list[dict] = []

    def _restore_or_init(self, params, opt_state):
        latest = self.ckpt.restore_latest((params, opt_state))
        if latest is None:
            return params, opt_state, 0
        (params, opt_state), step = latest
        log.info("restored checkpoint at step %d", step)
        return params, opt_state, step

    def run(self, params, opt_state):
        """Run to total_steps, surviving injected failures. Returns final state."""
        state = self._restore_or_init(params, opt_state)
        while True:
            try:
                return self._run_from(*state)
            except Exception as e:  # noqa: BLE001 — the whole point
                self.restarts += 1
                obs_metrics.counter("runner.restarts").inc()
                obs_metrics.event("runner_restart", restart=self.restarts,
                                  error=f"{type(e).__name__}: {e}")
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded restart budget ({self.cfg.max_restarts})") from e
                log.warning("step failed (%s); restart %d", e, self.restarts)
                self.ckpt.wait()
                restored = self.ckpt.restore_latest((state[0], state[1]))
                if restored is None:
                    state = (state[0], state[1], 0)
                else:
                    (p, o), step = restored
                    state = (p, o, step)

    def _run_from(self, params, opt_state, start_step: int):
        step = start_step
        for step, batch in self.data.iterate(start_step):
            if step >= self.cfg.total_steps:
                break
            if self.failure_hook is not None:
                self.failure_hook(step)      # may raise: injected fault
            with obs_trace.span("runner.step", step=step):
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
            obs_metrics.counter("runner.steps").inc()
            self.metrics_history.append(
                {"step": step, **{k: float(v) for k, v in metrics.items()}})
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, (params, opt_state),
                               blocking=not self.cfg.async_checkpoint)
        self.ckpt.wait()
        self.ckpt.save(self.cfg.total_steps, (params, opt_state), blocking=True)
        return params, opt_state
