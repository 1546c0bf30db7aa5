"""Training CLI: parameters + synthetic data + checkpoints + the
fault-tolerant runner, for any architecture of the registry, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2_1_5b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b --full \\
        --batch 2 --seq 4096 --steps 6              # full width on one card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch jamba_v0_1_52b \\
        --steps 8 --ckpt-dir /tmp/train_ckpt --ckpt-every 4   # resumable

Counterpart of ``python -m repro.launch.train``, with its flags plus
``--device`` (the card unless ``--device cpu``).  The smoke config is the
default, ``--full`` the published one.  With ``--ckpt-dir`` the run goes
through :class:`repro_torch.runtime.FaultTolerantRunner` and resumes from
the latest checkpoint there.  The reference shards its parameters over a
mesh when it has more than one device; this CLI trains on one device
(ROADMAP §1, item 3.5).  It prints the reference's lines, then one JSON
line: each step's loss, learning rate and milliseconds (host clock, ending
in a synchronise), the device's peak memory, and the launches of the
package's CUDA kernels (none on this path).
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
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.kernels import launch_counts
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig


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
                 step_ms: list | None = None):
    """The runner's ``train_step(params, opt, numpy_batch)``: the batch moved
    to ``device``, then :func:`repro_torch.models.model.make_train_step`'s
    step.  With ``step_ms``, each call's host milliseconds are appended,
    ending in a synchronise."""
    train_step = M.make_train_step(cfg, lr_peak=lr_peak, total_steps=total_steps)

    def stepper(p, o, batch):
        t0 = time.perf_counter()
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    dev = resolve_device(args.device)
    cfg, data = build(args.arch, full=args.full, seq_len=args.seq, global_batch=args.batch)
    print(f"arch={cfg.name} params={M.n_params(cfg):,} devices=1 ({device_name(dev)})")

    params = M.init_train_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(params)
    step_ms: list[float] = []
    stepper = make_stepper(cfg, dev, total_steps=args.steps, step_ms=step_ms)
    before = launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if args.ckpt_dir:
        runner = FaultTolerantRunner(
            RunnerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every),
            train_step=stepper, data=data, ckpt=CheckpointManager(args.ckpt_dir))
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
    out = dict(arch=cfg.name, device=device_name(dev), steps=[h["step"] for h in hist],
               losses=losses, lrs=[h["lr"] for h in hist], step_ms=step_ms,
               peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
               kernel_launches={k: after[k] - before[k] for k in after})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
