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

Across the ranks of a ``torch.distributed`` group the runner holds a state
that is the same on every rank (the CFD march gathers its fields after each
step), and every rank runs the same loop:

* rank 0 alone writes the checkpoints; the manager itself knows no ranks;
* a restore is a collective: rank 0 finishes its pending write, picks the
  step and reads it, and every rank receives the step and each leaf;
* before each step each rank runs its ``failure_hook`` and adds its outcome
  to one ``all_reduce_max`` flag, so when any rank fails every rank raises
  before the step's own collectives and all restore the same step;
* an exception raised inside the step on one rank leaves its peers in the
  step's collectives, so it is not survivable: it ends the run on that rank
  (:class:`StepFaultAcrossRanks`) instead of sending it into a restore.

On one rank nothing of this runs.

A state split over the ranks (``runtime/sharded.py``'s blocks) is handed a
``layout``: a checkpoint then holds the full tree in the reference's
layout, put together on every rank (``layout.full_state``, a collective)
and written by rank 0, and a restore reads it into full-shape buffers
(``layout.full_like``) and keeps this rank's blocks (``layout.local_state``).
A sharded checkpoint so restores in a one-rank run and the other way round.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, Protocol

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.core import dist
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

log = logging.getLogger(__name__)


class StepFaultAcrossRanks(RuntimeError):
    """A step raised on one rank of a multi-rank run, inside the step's
    collectives: its peers cannot join a restore, so the run ends."""


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
                 failure_hook: Callable[[int], None] | None = None, layout=None):
        self.cfg = cfg
        self.layout = layout
        self.train_step = train_step
        self.data = data
        self.ckpt = ckpt
        self.failure_hook = failure_hook
        self.restarts = 0
        self.metrics_history: list[dict] = []

    def _restore_or_init(self, params, opt_state):
        latest = self._restore_latest((params, opt_state))
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
            except StepFaultAcrossRanks:
                raise
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
                restored = self._restore_latest((state[0], state[1]))
                if restored is None:
                    state = (state[0], state[1], 0)
                else:
                    (p, o), step = restored
                    state = (p, o, step)

    def _save(self, step: int, tree, *, blocking: bool) -> None:
        if self.layout is not None:
            tree = self.layout.full_state(tree)
        if dist.is_root():      # across ranks the (full) state is everywhere the same
            self.ckpt.save(step, tree, blocking=blocking)

    def _restore_latest(self, like):
        """The manager's ``restore_latest``; across ranks rank 0 reads, after
        its pending write, and every rank receives the step and the leaves."""
        if self.layout is not None:
            like = self.layout.full_like(like)
        got = self._restore_full(like)
        if got is None or self.layout is None:
            return got
        return self.layout.local_state(got[0]), got[1]

    def _restore_full(self, like):
        if dist.world_size() == 1:
            return self.ckpt.restore_latest(like)
        root = dist.is_root()
        if root:
            self.ckpt.wait()
        step = dist.broadcast_object(self.ckpt.latest_step() if root else None)
        if step is None:
            return None
        tree = self.ckpt.restore(step, like)[0] if root else like
        leaves, treedef = flatten(tree)
        return unflatten(treedef, [dist.broadcast_from_root(t) for t in leaves]), step

    def _step(self, step: int, params, opt_state, batch):
        if dist.world_size() == 1:
            return self.train_step(params, opt_state, batch)
        try:
            return self.train_step(params, opt_state, batch)
        except Exception as e:  # noqa: BLE001 — re-raised as not survivable
            raise StepFaultAcrossRanks(
                f"step {step} raised on rank {dist.rank()} inside its collectives; across "
                f"ranks only a fault the failure hook reports before the step is "
                f"survivable") from e

    def _check_failure(self, step: int, params) -> None:
        """Run the failure hook; across ranks, raise on every rank when the
        hook raised on any (one ``all_reduce_max`` of a flag per step)."""
        if dist.world_size() == 1:
            if self.failure_hook is not None:
                self.failure_hook(step)
            return
        err = None
        if self.failure_hook is not None:
            try:
                self.failure_hook(step)
            except Exception as e:  # noqa: BLE001 — reported to every rank, re-raised
                err = e
        device = flatten(params)[0][0].device
        flag = dist.all_reduce_max(torch.tensor([float(err is not None)], device=device))
        if err is not None:
            raise err
        if float(flag[0]):
            raise RuntimeError(f"step {step} failed on another rank")

    def _run_from(self, params, opt_state, start_step: int):
        step = start_step
        for step, batch in self.data.iterate(start_step):
            if step >= self.cfg.total_steps:
                break
            self._check_failure(step, params)    # may raise: injected fault
            with obs_trace.span("runner.step", step=step):
                params, opt_state, metrics = self._step(step, params, opt_state, batch)
            obs_metrics.counter("runner.steps").inc()
            self.metrics_history.append(
                {"step": step, **{k: float(v) for k, v in metrics.items()}})
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self._save(step + 1, (params, opt_state),
                           blocking=not self.cfg.async_checkpoint)
        self.ckpt.wait()
        self._save(self.cfg.total_steps, (params, opt_state), blocking=True)
        return params, opt_state
