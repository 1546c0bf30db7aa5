"""Helpers for the training parity tests (``tests/test_torch_train_*.py``).

Both packages take the same weights (the JAX package's ``init_params``,
carried across leaf for leaf with ``tree_from_numpy``) and the same batch
(numpy, from a seed), and both compute in f32: ``loss_fn``'s value and
gradients, and one whole ``train_step`` from a fresh ``adamw_init``.  The
JAX side is one ``jax.jit`` per architecture holding both.

Tolerances:

* the loss and its parts: ``LOSS_ULPS`` f32 ulps of the reference's value;
  the learning rate bit for bit;
* every gradient leaf: ``GRAD_ULPS`` f32 ulps of the leaf's largest |g|
  (the reference's).  The chunked WKV and the selective scan make RWKV's and
  Jamba's gradients ill-conditioned in the reference itself: a 1-ulp change
  of half the parameters moves its own gradients by 440 ulps (RWKV) and 4,850
  (Jamba) of their leaves' largest, against 628 and 4,480 between the
  packages; the dense, MoE, Whisper and PaliGemma models stay within 15;
* the moments after the step: mu within the gradient's tolerance of its
  leaf's largest, nu within twice it (it is quadratic in g);
* the parameters after the step: AdamW's first step is ``lr * g / (|g| +
  eps)``, about ``lr * sign(g)``, so an entry whose gradient is rounding
  noise may flip: within ``2 lr`` (the flip bound) plus 4 ulps of |p|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_lm import ENC_FRAMES, EPS_F32, configs, jax_params

torch.set_num_threads(1)

B, T = 2, 32
LOSS_ULPS = 16
GRAD_ULPS = {"rwkv6_7b": 1024, "jamba_v0_1_52b": 8192}
DEFAULT_GRAD_ULPS = 32


def grad_ulps(arch: str) -> int:
    return GRAD_ULPS.get(arch, DEFAULT_GRAD_ULPS)


def make_batch(jc, seed: int = 3, b: int = B, t: int = T, mask: bool = True) -> dict:
    """A training batch as numpy: tokens and labels, a loss mask with about
    a fifth of the positions off (``mask``), and the VLM's patch embeddings
    or the encoder's frames (f32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jc.vocab, (b, t)).astype(np.int32),
           "labels": rng.integers(0, jc.vocab, (b, t)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((b, t)) > 0.2).astype(np.float32)
    if jc.frontend == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, jc.n_frontend_tokens, jc.d_model)).astype(np.float32)
    if jc.enc_dec:
        out["frames"] = rng.standard_normal((b, ENC_FRAMES, jc.d_model)).astype(np.float32)
    return out


def port_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return out


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def jax_step(jc, jp, batch: dict) -> dict:
    """The reference's ``loss_fn`` value and gradients and one
    ``make_train_step`` step from ``adamw_init``, under one ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.optim.adamw import adamw_init

    step = JM.make_train_step(jc)

    def both(p, b):
        (total, (loss, aux)), g = jax.value_and_grad(
            lambda q: JM.loss_fn(jc, q, b), has_aux=True)(p)
        p2, o2, m = step(p, adamw_init(p), b)
        return dict(total=total, loss=loss, aux=aux, grads=g, params=p2, mu=o2.mu, nu=o2.nu,
                    metrics=m)

    out = jax.jit(both)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return _np_tree(out)


def port_step(tc, jp, batch: dict) -> dict:
    """The port's ``loss_fn`` value and gradients (autograd) and one
    ``train_step`` from ``adamw_init``, on the CPU, from the reference's
    weights ``jp``."""
    from repro_torch.device import tensor_to_numpy
    from repro_torch.models import model as TM
    from repro_torch.models.param import map_tree, tree_from_numpy, tree_leaves, tree_to_numpy
    from repro_torch.optim.adamw import adamw_init

    tree = tree_from_numpy(_np_tree(jp), "cpu")
    tb = port_batch(batch)
    live = {k: t.detach().requires_grad_() for k, t in tree_leaves(tree)}
    p = map_tree(lambda k, _: live[k], tree, with_path=True)
    total, (loss, aux) = TM.loss_fn(tc, p, tb)
    g = dict(zip(live, torch.autograd.grad(total, list(live.values()))))
    grads = map_tree(lambda k, _: g[k], tree, with_path=True)
    p2, o2, m = TM.make_train_step(tc)(tree, adamw_init(tree), tb)
    num = lambda t: tensor_to_numpy(torch.as_tensor(t))
    return dict(total=num(total), loss=num(loss), aux=num(aux), grads=tree_to_numpy(grads),
                params=tree_to_numpy(p2), mu=tree_to_numpy(o2.mu), nu=tree_to_numpy(o2.nu),
                metrics=tree_to_numpy(m), before=tree_to_numpy(tree))


def leaf_ulps(got, want) -> dict[str, float]:
    """Each leaf's max |got - want| in f32 ulps of the leaf's largest |want|."""
    from repro_torch.models.param import tree_leaves

    out = {}
    want_leaves = dict(tree_leaves(want))
    for path, g in tree_leaves(got):
        w = np.asarray(want_leaves[path], np.float64)
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        out[path] = float(np.abs(g - w).max() / (EPS_F32 * max(np.abs(w).max(), 1e-30)))
    return out


def scalar_ulps(got, want) -> float:
    g, w = float(got), float(want)
    return abs(g - w) / (EPS_F32 * max(abs(w), 1e-30))


def check_step(arch: str) -> dict:
    """The smoke config of ``arch`` in f32: the port's loss, gradients and
    one train step against the reference's (module docstring's
    tolerances).  Returns the largest gaps seen."""
    from repro_torch.models.param import tree_leaves

    jc, tc = configs(arch, "f32")
    jp = jax_params(jc)
    batch = make_batch(jc)
    ref = jax_step(jc, jp, batch)
    got = port_step(tc, jp, batch)
    tol = grad_ulps(arch)
    seen = {k: scalar_ulps(got[k], ref[k]) for k in ("total", "loss", "aux")}
    for k in ("total", "loss", "aux"):
        assert seen[k] <= LOSS_ULPS, (arch, k, got[k], ref[k], seen[k])
    assert np.isfinite(got["loss"]) and float(got["loss"]) > 0
    g = leaf_ulps(got["grads"], ref["grads"])
    seen["grads"] = max(g.values())
    assert seen["grads"] <= tol, (arch, sorted(g.items(), key=lambda kv: -kv[1])[:4])
    mu, nu = leaf_ulps(got["mu"], ref["mu"]), leaf_ulps(got["nu"], ref["nu"])
    seen["mu"], seen["nu"] = max(mu.values()), max(nu.values())
    assert seen["mu"] <= tol + 4 and seen["nu"] <= 2 * tol + 4, (arch, seen)

    gm, rm = got["metrics"], ref["metrics"]
    assert set(gm) == set(rm) == {"loss", "aux_loss", "total_loss", "lr", "grad_step"}
    for k in ("loss", "aux_loss", "total_loss"):
        assert scalar_ulps(gm[k], rm[k]) <= LOSS_ULPS, (arch, k, gm[k], rm[k])
    assert float(gm["lr"]) == float(rm["lr"]), (arch, gm["lr"], rm["lr"])
    assert int(gm["grad_step"]) == int(rm["grad_step"]) == 1
    lr = float(rm["lr"])
    flips = 0
    ref_params = dict(tree_leaves(ref["params"]))
    for path, p in tree_leaves(got["params"]):
        want = np.asarray(ref_params[path], np.float64)
        gap = np.abs(np.asarray(p, np.float64) - want)
        bound = 2 * lr + 4 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (gap <= bound).all(), (arch, path, float(gap.max()), lr)
        flips += int((gap > 4 * np.spacing(np.abs(want).astype(np.float32))).sum())
    changed = any(not np.array_equal(a, dict(tree_leaves(got["before"]))[k])
                  for k, a in tree_leaves(got["params"]))
    assert changed, arch
    seen["flipped_entries"] = flips
    print(arch, {k: round(v, 2) if isinstance(v, float) else v for k, v in seen.items()})
    return seen


def step_test(archs: list[str]):
    """A test function over ``archs`` for a ``test_torch_train_step_*`` file."""
    @pytest.mark.parametrize("arch", archs)
    def test_loss_grads_and_train_step_match_jax(arch):
        check_step(arch)

    return test_loss_grads_and_train_step_match_jax
