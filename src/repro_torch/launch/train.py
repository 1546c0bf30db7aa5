"""Training CLI: parameters + synthetic data + checkpoints + the
fault-tolerant runner, for any architecture of the registry, on one device
or across the ranks of a ``torchrun`` group.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2_1_5b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b --full \\
        --batch 2 --seq 4096 --steps 6              # full width on one card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch jamba_v0_1_52b \\
        --steps 8 --ckpt-dir /tmp/train_ckpt --ckpt-every 4   # resumable
    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --arch qwen2_moe_a2_7b --steps 6  # 2x2 ranks

Counterpart of ``python -m repro.launch.train``, with its flags plus
``--device`` (the card unless ``--device cpu``) and ``--dist-backend``
(``launch/solve.py``'s: nccl between cards, one rank a card; gloo on the
CPU or for ranks sharing a card).  The smoke config is the default,
``--full`` the published one.  With ``--ckpt-dir`` the run goes through
:class:`repro_torch.runtime.FaultTolerantRunner` and resumes from the
latest checkpoint there.  Under ``torchrun`` with more than one rank, as the
reference does when it sees more than one device, the run lays the ranks
out as ``make_mesh_for_devices()`` and trains through
``runtime/sharded.py``: each rank keeps its ``physical_spec`` blocks of the
parameters and its ZeRO-1 blocks of the moments, and takes its shard of the
global batch; a checkpoint holds the full tree (rank 0 writes it), so it
restores on any number of ranks.  Rank 0 prints the reference's lines, then
one JSON line: each step's loss, learning rate and milliseconds (host
clock, ending in a synchronise), the device's peak memory, the launches of
the package's CUDA kernels (none on this path), and per rank the stored
parameter and moment bytes and the bytes staged through the host a step.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import dist
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.device import device_name, synchronize
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.solve import join_ranks, leave_ranks, root_prints
from repro_torch.models import model as M
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig
from repro_torch.runtime.sharded import ShardedLayout, make_sharded_train_step


def build(arch: str, *, full: bool = False, seq_len: int = 64, global_batch: int = 4,
          seed: int = 0):
    """(config, data): the smoke or published config and its synthetic
    stream, with the VLM's patch embeddings and the encoder's frames (one
    per token) drawn from the stream's seed and step."""
    cfg = get_config(arch) if full else get_smoke(arch)
    extras = {}
    if cfg.frontend == "vlm":
        extras["patch_embeds"] = ((cfg.n_frontend_tokens, cfg.d_model), np.float32)
    if cfg.enc_dec:
        extras["frames"] = ((seq_len, cfg.d_model), np.float32)
    data = SyntheticLMData(
        DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed),
        extras=extras)
    return cfg, data


def to_device(cfg, batch: dict, device: torch.device) -> dict:
    """A numpy batch of the stream as tensors on ``device``: token ids as
    int64, the modality inputs in the model's dtype (``_adapt_modality``)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return _adapt_modality(cfg, out)


def _adapt_modality(cfg, batch: dict) -> dict:
    b = dict(batch)
    if cfg.frontend == "vlm" and "patch_embeds" in b:
        b["patch_embeds"] = b["patch_embeds"].to(cfg.dtype)
    if cfg.enc_dec and "frames" in b:
        b["frames"] = b["frames"].to(cfg.dtype)
    return b


def make_stepper(cfg, device: torch.device, *, lr_peak: float = 3e-4, total_steps: int,
                 step_ms: list | None = None, layout: ShardedLayout | None = None):
    """The runner's ``train_step(params, opt, numpy_batch)``: the batch moved
    to ``device``, then :func:`repro_torch.models.model.make_train_step`'s
    step; with ``layout``, this rank's shard of the batch and
    :func:`repro_torch.runtime.sharded.make_sharded_train_step`'s step on
    this rank's blocks.  With ``step_ms``, each call's host milliseconds are
    appended, ending in a synchronise."""
    if layout is None:
        train_step = M.make_train_step(cfg, lr_peak=lr_peak, total_steps=total_steps)
    else:
        train_step = make_sharded_train_step(cfg, layout, lr_peak=lr_peak,
                                             total_steps=total_steps)

    def stepper(p, o, batch):
        t0 = time.perf_counter()
        if layout is not None:
            batch = layout.batch_shard(batch)
        out = train_step(p, o, to_device(cfg, batch, device))
        if step_ms is not None:
            synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return stepper


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="full published config (default: smoke twin)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=list(dist.BACKENDS),
                    help="torch.distributed backend under torchrun (default nccl on the "
                         "card, one rank per card; gloo on the CPU, or to share a card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    own_group = dist.launched() and not dist.initialized()
    dev = join_ranks(args.dist_backend, args.device)
    with root_prints():
        out = run(args, dev)
    if own_group:
        leave_ranks()
    return out


def run(args, dev: torch.device) -> dict:
    world = dist.world_size()
    cfg, data = build(args.arch, full=args.full, seq_len=args.seq, global_batch=args.batch)
    print(f"arch={cfg.name} params={M.n_params(cfg):,} devices={world} ({device_name(dev)})")

    params = M.init_train_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(params)
    layout = None
    if world > 1:
        mesh = make_mesh_for_devices()
        layout = ShardedLayout(cfg, mesh, args.batch)
        params, opt = layout.local_state((params, opt))
        print(f"on rank mesh {mesh.shape}, batch split {layout.shards} ways")
    step_ms: list[float] = []
    stepper = make_stepper(cfg, dev, total_steps=args.steps, step_ms=step_ms, layout=layout)
    before = launch_counts()
    staged = obs_metrics.counter("comm.host_staged_bytes").value
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if args.ckpt_dir:
        runner = FaultTolerantRunner(
            RunnerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every),
            train_step=stepper, data=data, ckpt=CheckpointManager(args.ckpt_dir),
            layout=layout)
        t0 = time.time()
        params, opt = runner.run(params, opt)
        hist = runner.metrics_history
    else:
        hist = []
        t0 = time.time()
        for step, batch in data.iterate(0):
            if step >= args.steps:
                break
            params, opt, m = stepper(params, opt, batch)
            hist.append({"step": step, "loss": float(m["loss"]), "lr": float(m["lr"])})
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {float(m['loss']):.4f}")
    dt = time.time() - t0
    losses = [h["loss"] for h in hist]
    if losses:
        print(f"done: {len(losses)} steps in {dt:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"done: 0 steps in {dt:.1f}s (resumed at the last step)")
    after = launch_counts()
    staged = (obs_metrics.counter("comm.host_staged_bytes").value - staged) / max(len(hist), 1)
    mine = dict(param_bytes=ShardedLayout.stored_bytes(params),
                moment_bytes=ShardedLayout.stored_bytes((opt.mu, opt.nu)),
                host_staged_bytes_per_step=staged)
    ranks = dist.all_gather_object(mine) if world > 1 else [mine]
    out = dict(arch=cfg.name, device=device_name(dev), ranks=world,
               mesh=layout.mesh.shape if layout else None,
               steps=[h["step"] for h in hist],
               losses=losses, lrs=[h["lr"] for h in hist], step_ms=step_ms,
               peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
               kernel_launches={k: after[k] - before[k] for k in after},
               **{k: [r[k] for r in ranks] for k in mine})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
