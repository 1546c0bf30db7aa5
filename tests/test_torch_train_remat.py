"""The port's training step on its own, for every architecture's smoke
config (no JAX): remat changes no bit, a step is deterministic, and the
bf16 step of the configs as published trains.

* ``loss_fn``'s gradients with ``remat`` (each block under
  ``torch.utils.checkpoint``) equal those without, bit for bit, in f32.
* The same ``train_step`` twice from the same state gives the same
  parameters, moments and metrics, bit for bit.
* In the configs' own bf16: the loss is finite, the step count is 1 and
  some parameter leaf changed (the reference's ``test_smoke_train_step``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_train import make_batch, port_batch  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.param import map_tree, tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


def _setup(arch: str, dtype=torch.float32):
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    tree = TM.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = port_batch(make_batch(cfg, seed=4))
    for k in ("patch_embeds", "frames"):
        if k in batch:
            batch[k] = batch[k].to(dtype)
    return cfg, tree, batch


def _grads(cfg, tree, batch):
    live = {k: t.detach().requires_grad_() for k, t in tree_leaves(tree)}
    p = map_tree(lambda k, _: live[k], tree, with_path=True)
    total, _ = TM.loss_fn(cfg, p, batch)
    return total.detach(), torch.autograd.grad(total, list(live.values()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gradients_equal_plain_bit_for_bit(arch):
    cfg, tree, batch = _setup(arch)
    assert cfg.remat
    t1, g1 = _grads(cfg, tree, batch)
    t0, g0 = _grads(dataclasses.replace(cfg, remat=False), tree, batch)
    assert torch.equal(t1, t0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_is_deterministic(arch):
    cfg, tree, batch = _setup(arch)
    step = TM.make_train_step(cfg)
    outs = [step(tree, adamw_init(tree), batch) for _ in range(2)]
    a, b = ([t for _, t in tree_leaves(o)] for o in outs)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_train_step_trains(arch):
    cfg, tree, batch = _setup(arch, get_smoke(arch).dtype)
    p2, o2, m = TM.make_train_step(cfg)(tree, adamw_init(tree), batch)
    assert np.isfinite(float(m["loss"])) and int(o2.count) == int(m["grad_step"]) == 1
    assert set(m) == {"loss", "aux_loss", "total_loss", "lr", "grad_step"}
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(tree),
                                                              tree_leaves(p2)))
    for (_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(p2)):
        assert a.dtype == b.dtype and a.shape == b.shape
