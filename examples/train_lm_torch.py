"""End-to-end LM training on the PyTorch port: train a model a few hundred
steps on the synthetic-motif dataset and watch the loss drop, with a
failure injected mid-run and survived through checkpoint/restart.  The
counterpart of ``examples/train_lm.py``, with the same flags plus
``--device`` (the card unless ``--device cpu``).

The default is an ~8M-param model (``demo_8m``); ``--hundred-m`` trains the
~100M configuration (``demo_100m``), the same code path with bigger dims.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --hundred-m
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 120 --seq 32
"""

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.device import device_name, resolve_device
from repro_torch.launch.train import make_stepper
from repro_torch.models import model as M
from repro_torch.models.transformer import ArchConfig, LayerSpec
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig


def hundred_m_config() -> ArchConfig:
    """~100M params: a scaled qwen2-style decoder."""
    return ArchConfig(
        name="demo_100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_head=64, d_ff=3072, vocab=16384,
        period=(LayerSpec(kind="attn"),), qkv_bias=True,
        tie_embeddings=True, norm="rmsnorm", act="swiglu", remat=False)


def eight_m_config() -> ArchConfig:
    """~8M params: the same family sized for a CPU demo."""
    return ArchConfig(
        name="demo_8m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_head=64, d_ff=1024, vocab=4096,
        period=(LayerSpec(kind="attn"),), qkv_bias=True,
        tie_embeddings=True, norm="rmsnorm", act="swiglu", remat=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hundred-m", action="store_true", help="~100M-param config")
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = hundred_m_config() if args.hundred_m else eight_m_config()
    print(f"model: {cfg.name}, {M.n_params(cfg):,} params on {device_name(dev)}")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch, seed=3))
    params = M.init_train_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(params)
    stepper = make_stepper(cfg, dev, lr_peak=6e-4, total_steps=args.steps)

    boom = {"armed": args.inject_failure}

    def failure_hook(step):
        if boom["armed"] and step == args.steps // 2:
            boom["armed"] = False
            raise RuntimeError("injected mid-run preemption")

    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(
            RunnerConfig(total_steps=args.steps, checkpoint_every=50),
            train_step=stepper, data=data, ckpt=CheckpointManager(d),
            failure_hook=failure_hook)
        t0 = time.time()
        params, opt = runner.run(params, opt)
        dt = time.time() - t0

    hist = runner.metrics_history
    w = 20
    first = sum(h["loss"] for h in hist[:w]) / w
    last = sum(h["loss"] for h in hist[-w:]) / w
    print(f"{len(hist)} recorded steps in {dt:.0f}s "
          f"(restarts survived: {runner.restarts})")
    print(f"loss: first-{w}-avg {first:.3f} -> last-{w}-avg {last:.3f}")
    assert last < first - 0.5, "model failed to learn the motif structure"
    print("OK: loss dropped; checkpoint/restart exercised" if runner.restarts
          else "OK: loss dropped")


if __name__ == "__main__":
    main()
