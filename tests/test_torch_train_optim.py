"""The port's optimizer (``repro_torch.optim``) against the JAX package's
(``repro.optim``), fed the same inputs: ``cosine_lr``, ``global_norm``,
``adamw_update`` (from the same gradients and state, f32 and bf16
parameters, with and without clipping) and the int8 compression with error
feedback; plus the reference's own optimizer tests, mirrored.

XLA on the CPU contracts ``a * b + c`` into FMAs and the port does not, so
an expression with a product and a sum is held to 2 f32 ulps of its
largest term (4 for the parameter update, whose inputs carry those of the
moments), and one without is held bit for bit: the warm-up branch of
``cosine_lr``, the int8 values and scales, ``decompress_grads``.  A
bfloat16 parameter, rounded from those f32 values, is held to one bfloat16
ulp.  ``global_norm`` sums in another order: 8 ulps; with clipping, the
clip scale carries those 8 ulps into every gradient term (twice into the
squared one), and the tolerances grow by as much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_port import assert_bitwise, assert_ulp_close, to_np, to_t  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.models.param import map_tree, tree_leaves  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWState, adamw_init, adamw_update, compress_grads, cosine_lr, decompress_grads,
    global_norm,
)

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
NORM_ULPS = 8


def _tree(seed: int, bf16: bool = True) -> dict:
    """A nested parameter-like tree of numpy arrays: f32 and bf16 leaves."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = {"embed": f(50, 16), "final_norm": {"w": 1 + 0.1 * f(16)},
         "layers": {"pos0": {"attn": {"wq": f(2, 16, 4, 4), "bq": f(2, 4, 4)},
                             "mlp": {"up": f(2, 16, 40)}}}}
    if bf16:
        t["embed"] = np.asarray(jnp.asarray(t["embed"], jnp.bfloat16))
        t["layers"]["pos0"]["mlp"]["up"] = np.asarray(
            jnp.asarray(t["layers"]["pos0"]["mlp"]["up"], jnp.bfloat16))
    return t


def _grads(params: dict, seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return map_tree(lambda a: np.asarray(jnp.asarray(
        scale * rng.standard_normal(a.shape).astype(np.float32), a.dtype)), params)


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return map_tree(to_t, tree)


def _tstate(s) -> AdamWState:
    return AdamWState(mu=_tt(s["mu"]), nu=_tt(s["nu"]),
                      count=torch.tensor(s["count"], dtype=torch.int32))


def _bf16_ulp_close(actual, expected) -> None:
    a, e = to_np(actual).astype(np.float64), to_np(expected).astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(e))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    assert (np.abs(a - e) <= ulp).all(), float(np.max(np.abs(a - e) / ulp))


@pytest.mark.parametrize("sched", [(3e-4, 100, 10000, 0.1), (1.0, 10, 100, 0.1),
                                   (6e-4, 100, 200, 0.0)])
def test_cosine_lr_matches_jax(sched):
    peak, warmup, total, floor = sched
    for step in (0, 1, 5, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                 total + 50):
        kw = dict(peak=peak, warmup=warmup, total=total, floor=floor)
        want = np.float32(jadamw.cosine_lr(jnp.int32(step), **kw))
        got = cosine_lr(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        if step < warmup:           # peak * (step + 1) / warmup: no product-sum to contract
            assert_bitwise(got, want)
        else:
            assert_ulp_close(got, want, scale=max(peak, abs(float(want))), n_ulp=2)
        assert_bitwise(cosine_lr(step, **kw), got)      # an int step reads the same


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_matches_jax(seed):
    g = _grads(_tree(seed), seed + 10)
    want = float(jadamw.global_norm(_jt(g)))
    got = global_norm(_tt(g))
    assert got.dtype == torch.float32
    assert_ulp_close(got, np.float32(want), scale=want, n_ulp=NORM_ULPS)


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "no_clip"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16_leaves", "f32_leaves"])
def test_adamw_update_matches_jax_from_the_same_grads(clip, bf16):
    """Three steps; each step starts both packages from the reference's
    state (so only that step's arithmetic is compared) with the same
    gradients (norm above the clip, so the clip scales them)."""
    params = _tree(3, bf16)
    jp, jstate = _jt(params), jadamw.adamw_init(_jt(params))
    for k in range(3):
        grads = _grads(params, 20 + k, scale=0.3)
        lr = jadamw.cosine_lr(jstate.count, peak=1e-2, warmup=2, total=10)
        s = jax.tree.map(np.asarray, dict(mu=jstate.mu, nu=jstate.nu, count=jstate.count))
        want_p, want_s = jadamw.adamw_update(jp, _jt(grads), jstate, lr=lr, clip_norm=clip)
        got_p, got_s = adamw_update(_tt(jax.tree.map(np.asarray, jp)), _tt(grads), _tstate(s),
                                    lr=torch.tensor(np.float32(lr)), clip_norm=clip)
        assert int(got_s.count) == int(want_s.count) == k + 1
        gn = float(jadamw.global_norm(_jt(grads)))
        scale = 1.0 if clip is None else min(1.0, clip / gn)
        assert scale < 1.0 or clip is None
        c1, c2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
        want_leaves = dict(tree_leaves(jax.tree.map(np.asarray, want_p)))
        for path, g in tree_leaves(grads):
            gf = g.astype(np.float64) * scale
            m = np.asarray(dict(tree_leaves(s["mu"]))[path], np.float64)
            n = np.asarray(dict(tree_leaves(s["nu"]))[path], np.float64)
            m_got, m_want = dict(tree_leaves(got_s.mu))[path], dict(tree_leaves(want_s.mu))[path]
            n_got, n_want = dict(tree_leaves(got_s.nu))[path], dict(tree_leaves(want_s.nu))[path]
            norm_ulps = 0 if clip is None else NORM_ULPS
            assert_ulp_close(m_got, m_want, np.maximum(np.abs(B1 * m), np.abs((1 - B1) * gf)),
                             n_ulp=2 + norm_ulps)
            assert_ulp_close(n_got, n_want, np.maximum(np.abs(B2 * n), (1 - B2) * gf * gf),
                             n_ulp=2 + 2 * norm_ulps)
            p = np.asarray(dict(tree_leaves(jax.tree.map(np.asarray, jp)))[path]).astype(
                np.float64)
            mw, nw = to_np(m_want).astype(np.float64), to_np(n_want).astype(np.float64)
            st = np.abs(mw / c1) / (np.sqrt(nw / c2) + EPS)
            p_got, p_want = dict(tree_leaves(got_p))[path], want_leaves[path]
            assert p_got.dtype == (torch.bfloat16 if p_want.dtype.name == "bfloat16"
                                   else torch.float32)
            if p_got.dtype == torch.bfloat16:
                _bf16_ulp_close(p_got, p_want)
            else:
                assert_ulp_close(p_got, p_want, np.abs(p) + float(lr) * (st + WD * np.abs(p)),
                                 n_ulp=4 + norm_ulps)
        jp, jstate = want_p, want_s


def test_adamw_update_leaves_its_inputs_unchanged():
    params, grads = _tt(_tree(4)), _tt(_grads(_tree(4), 5))
    state = adamw_init(params)
    before = [t.clone() for _, t in tree_leaves((params, grads, state))]
    adamw_update(params, grads, state, lr=0.1)
    after = [t for _, t in tree_leaves((params, grads, state))]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_compression_matches_jax_over_two_rounds():
    """int8 values and scales bit for bit; the carried error within 2 ulps
    of max(|g + e|, |q * scale|) (``gf - q * scale`` may contract); the
    second round starts both from the reference's error."""
    grads = _grads(_tree(6), 7)
    jerr, terr = None, None
    for r in range(2):
        jq, js, je = jcompress.compress_grads(_jt(grads), jerr)
        tq, ts, te = compress_grads(_tt(grads), terr)
        for path, q in tree_leaves(tq):
            assert q.dtype == torch.int8
            assert_bitwise(q, dict(tree_leaves(jax.tree.map(np.asarray, jq)))[path])
            s_want = dict(tree_leaves(jax.tree.map(np.asarray, js)))[path]
            assert_bitwise(dict(tree_leaves(ts))[path], s_want)
            gf = to_np(q).astype(np.float64) * float(s_want)
            e_in = 0 if jerr is None else np.asarray(dict(tree_leaves(jerr))[path], np.float64)
            big = np.maximum(np.abs(dict(tree_leaves(grads))[path].astype(np.float64) + e_in),
                             np.abs(gf))
            assert_ulp_close(dict(tree_leaves(te))[path],
                             dict(tree_leaves(jax.tree.map(np.asarray, je)))[path], big)
        assert_bitwise(dict(tree_leaves(decompress_grads(tq, ts)))["embed"],
                       dict(tree_leaves(jax.tree.map(np.asarray, jcompress.decompress_grads(
                           jq, js))))["embed"])
        jerr, terr = je, _tt(jax.tree.map(np.asarray, je))


# -- the reference's own optimizer tests (tests/test_substrate.py), mirrored ----------

def test_cosine_schedule_shape():
    assert abs(float(cosine_lr(0, peak=1.0, warmup=10, total=100)) - 0.1) < 1e-6
    assert abs(float(cosine_lr(10, peak=1.0, warmup=10, total=100)) - 1.0) < 1e-6
    assert abs(float(cosine_lr(100, peak=1.0, warmup=10, total=100, floor=0.1)) - 0.1) < 1e-6


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(300):
        params, opt = adamw_update(params, {"w": 2 * params["w"]}, opt, lr=0.05,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    p2, _ = adamw_update(params, {"w": torch.full((4,), 1e6)}, adamw_init(params), lr=0.1,
                         clip_norm=1.0, weight_decay=0.0)
    assert float(p2["w"].abs().max()) < 1.0


def test_compression_error_feedback_preserves_convergence():
    params = {"w": torch.tensor([3.0, -2.0, 1.5, -0.5])}
    opt, err = adamw_init(params), None
    for _ in range(400):
        q, scales, err = compress_grads({"w": 2 * params["w"]}, err)
        params, opt = adamw_update(params, decompress_grads(q, scales), opt, lr=0.05,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 2e-2


def test_compression_is_4x_smaller():
    g = {"w": torch.ones(1024)}
    q, s, e = compress_grads(g, None)
    assert q["w"].dtype == torch.int8
    assert q["w"].nbytes == g["w"].nbytes // 4


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.ones(4, 3)}
    np.testing.assert_allclose(float(global_norm(t)), np.sqrt(15.0), rtol=1e-6)
