"""The port's ``cross_entropy_loss`` and ``loss_fn`` against the JAX
package's, from the same inputs.

* f32 logits, with a mask and with ``z_loss`` on and off: the value within
  4 f32 ulps and every gradient entry within 4 ulps of the largest
  (sums over the vocabulary in other orders).
* bf16 logits: ``logits - m`` rounds to bf16 in the port (the reference's
  strict arithmetic), which XLA's default excess precision may skip; each
  exponent then moves by at most 2^-9 |l - m|, so the loss is held to
  2^-9 max|l - m| (1 + 2 z |lse|) of the reference's, and the port to a
  float64 evaluation of that rounding order within 1e-6.
* ``loss_fn`` over a text length that 8 does not divide (the chunk count
  falls to the largest divisor) and without a ``loss_mask`` key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_lm import EPS_F32, configs, jax_params  # noqa: E402
from _torch_port import to_np, to_t  # noqa: E402
from _torch_train import leaf_ulps, make_batch, port_batch, scalar_ulps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import cross_entropy_loss  # noqa: E402
from repro_torch.models.param import tree_from_numpy  # noqa: E402

B, T, V = 2, 12, 97


def _inputs(dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = np.asarray(jnp.asarray(4 * rng.standard_normal((B, T, V)).astype(np.float32),
                                    dtype))
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    return logits, targets, mask


def _both(logits, targets, mask, z_loss):
    jf = jax.value_and_grad(lambda l: JL.cross_entropy_loss(l, jnp.asarray(targets),
                                                            jnp.asarray(mask), z_loss=z_loss))
    jv, jg = jf(jnp.asarray(logits))
    tl = to_t(logits).requires_grad_()
    tv = cross_entropy_loss(tl, torch.from_numpy(targets), torch.from_numpy(mask),
                            z_loss=z_loss)
    (tg,) = torch.autograd.grad(tv, tl)
    return float(tv.detach()), to_np(tg), float(jv), to_np(jg)


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_f32_matches_jax(z_loss):
    logits, targets, mask = _inputs(jnp.float32)
    tv, tg, jv, jg = _both(logits, targets, mask, z_loss)
    assert scalar_ulps(tv, jv) <= 4, (tv, jv)
    assert tg.dtype == np.float32
    assert np.abs(tg - jg).max() <= 4 * EPS_F32 * np.abs(jg).max()
    assert (tg[mask == 0] == 0).all()


def _rounded_loss_f64(logits, targets, mask, z_loss) -> float:
    """The port's rounding order in float64: ``logits - m`` rounded to bf16
    (one rounding of the exact difference), everything else exact."""
    x = logits.astype(np.float64)
    m = x.max(-1, keepdims=True)
    d = torch.from_numpy(x - m).to(torch.bfloat16).double().numpy()
    lse = m[..., 0] + np.log(np.exp(d).sum(-1))
    gold = np.take_along_axis(x, targets[..., None].astype(np.int64), -1)[..., 0]
    nll = lse - gold + z_loss * lse ** 2
    return float((nll * mask).sum() / max(mask.sum(), 1.0)), float(np.abs(lse).max())


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_bf16_matches_jax_within_the_rounding_of_logits_minus_max(z_loss):
    logits, targets, mask = _inputs(jnp.bfloat16, seed=1)
    tv, tg, jv, jg = _both(logits, targets, mask, z_loss)
    want64, lse_max = _rounded_loss_f64(logits, targets, mask, z_loss)
    assert abs(tv - want64) <= 1e-6 * abs(want64)
    x = logits.astype(np.float64)
    spread = float((x.max(-1, keepdims=True) - x).max())
    assert abs(tv - jv) <= 2.0 ** -9 * spread * (1 + 2 * z_loss * lse_max) + 8 * EPS_F32 * abs(jv)
    # gradients: each entry is w (p_v - [v = target]) (1 + 2 z lse) rounded to bf16,
    # with p_v moved by at most 2 x 2^-9 x spread (relative) between the packages
    bound = np.abs(jg) * (2.0 ** -8 * spread + 2.0 ** -7) + 2.0 ** -7 * np.abs(jg).max() * 2 ** -8
    assert (np.abs(tg - jg) <= bound).all(), float(np.max(np.abs(tg - jg) - bound))


def test_loss_fn_with_a_ragged_chunk_count_and_no_mask():
    """T = 30: 8 chunks fall to 6 of 5 tokens; no ``loss_mask`` means all ones."""
    jc, tc = configs("qwen2_1_5b", "f32")
    jp = jax_params(jc)
    batch = make_batch(jc, seed=5, t=30, mask=False)
    (jt, (jl, ja)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jc, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    from repro_torch.models.param import map_tree, tree_leaves

    live = {k: t.requires_grad_() for k, t in tree_leaves(tree)}
    tt, (tl, ta) = TM.loss_fn(tc, tree, port_batch(batch))
    grads = dict(zip(live, torch.autograd.grad(tt, list(live.values()))))
    assert scalar_ulps(tt.detach(), jt) <= 16 and scalar_ulps(tl.detach(), jl) <= 16
    assert float(ta) == float(ja) == 0.0
    got = map_tree(lambda k, _: to_np(grads[k]), tree, with_path=True)
    assert max(leaf_ulps(got, jax.tree.map(np.asarray, jg)).values()) <= 32
