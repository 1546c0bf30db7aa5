"""The port's serving path in bfloat16 against ``repro.models.model`` run
with ``--xla_allow_excess_precision=false`` (in a subprocess: XLA reads its
flags once per process).

In that strict mode JAX rounds every bfloat16 operation as written, as the
port does (ROADMAP §3); in its default mode XLA skips roundings inside
fused expressions.  The yardstick is JAX's own gap between its two modes on
the same weights and tokens: the port may be no further from strict JAX
than default JAX is (``MODE_GAP_MULTIPLE``).  Decodes are fed strict JAX's
greedy tokens on all three sides, so one near-tie cannot fork the
sequences.  Seen: the port's logits equal strict JAX's bit for bit in
91-99.99% of entries, the largest gap 0.031 against the modes' 0.031-0.063.
"""

import json
import pathlib

import numpy as np
import pytest

from _torch_lm import ARCHS, STEPS, carry, configs, jax_params, jax_serve, port_serve, prompt
from _torch_port import run_python

MODE_GAP_MULTIPLE = 1.0

#: (arch, attn_block)
CASES = [(a, None) for a in ARCHS] + [("qwen2_1_5b", 8)]
IDS = [f"{a}-block{b}" if b else a for a, b in CASES]

_STRICT = """
import json, sys
import numpy as np
sys.path.insert(0, "tests")
from _torch_lm import configs, jax_params, jax_serve, prompt
out = sys.argv[1]
for arch, block in json.loads(sys.argv[2]):
    jc, _ = configs(arch, "bf16", block=block)
    r = jax_serve(jc, jax_params(jc), prompt(jc.vocab))
    np.savez(f"{out}/{arch}_{block}.npz", logits=np.stack(r["logits"]),
             tokens=np.stack(r["tokens"]),
             **{f"{when}_{n}_{kv}": c[kv] for when in ("prefill_caches", "caches")
                for n, c in enumerate(r[when]) for kv in ("k", "v")})
print("ok")
"""


@pytest.fixture(scope="module")
def strict(tmp_path_factory) -> pathlib.Path:
    out = tmp_path_factory.mktemp("strict_jax")
    res = run_python(_STRICT.replace("sys.argv[1]", repr(str(out))).replace(
        "sys.argv[2]", repr(json.dumps(CASES))), env_extra={
        "XLA_FLAGS": "--xla_allow_excess_precision=false", "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    return out


def _caches(r: dict) -> dict:
    return {f"{when}_{n}_{kv}": c[kv] for when in ("prefill_caches", "caches")
            for n, c in enumerate(r[when]) for kv in ("k", "v")}


@pytest.mark.parametrize("arch,block", CASES, ids=IDS)
def test_bf16_serving_within_jax_precision_mode_gap(strict, arch, block):
    ref = np.load(strict / f"{arch}_{block}.npz")
    jc, tc = configs(arch, "bf16", block=block)
    jp = jax_params(jc)
    toks = prompt(jc.vocab)
    forced = ref["tokens"]
    default = jax_serve(jc, jp, toks, forced=forced)
    got = port_serve(tc, carry(tc, jp), toks, forced=forced)
    assert len(got["logits"]) == STEPS + 1

    def gaps(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    port_gap = gaps(np.stack(got["logits"]), ref["logits"])
    mode_gap = gaps(np.stack(default["logits"]), ref["logits"])
    assert mode_gap > 0, "strict and default JAX agree: the subprocess lost its flag"
    assert port_gap <= MODE_GAP_MULTIPLE * mode_gap, (port_gap, mode_gap)

    port_c, default_c = _caches(got), _caches(default)
    for name, want in ((k, ref[k]) for k in port_c):
        assert gaps(port_c[name], want) <= MODE_GAP_MULTIPLE * max(
            gaps(default_c[name], want), 2.0 ** -8 * np.abs(want).max()), name
