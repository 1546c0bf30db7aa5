"""The port's LM registry, full-width structure and entry points, and its
stencil-family configs, against the JAX package's.

Full-width checks build ``ParamDef`` trees only: nothing is allocated.
"""

import dataclasses
import math
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_lm import ARCHS, FAMILY_ARCHS, MOE_ARCHS
from _torch_port import REPO, run_python
from repro import configs as jreg
from repro.configs import stencil_box27 as jbox, stencil_star25_seismic as jrtm
from repro.models import model as JM, param as jparam, transformer as jtr
from repro_torch import configs as treg
from repro_torch.configs import stencil_box27 as tbox, stencil_star25_seismic as trtm
from repro_torch.models import model as TM, param as tparam, transformer as ttr

ALL_ARCHS = ARCHS + MOE_ARCHS + FAMILY_ARCHS
_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int32: jnp.int32}


def _norm(v):
    """A config field as a comparable value (dtypes by name, specs as dicts)."""
    if isinstance(v, torch.dtype):
        return jnp.dtype(_JDT[v]).name
    if isinstance(v, type) or isinstance(v, jnp.dtype):
        return jnp.dtype(v).name
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def _fields(cfg) -> dict:
    return {f.name: _norm(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_the_reference_field_by_field(arch, which):
    get_t, get_j = ((treg.get_config, jreg.get_config) if which == "config"
                    else (treg.get_smoke, jreg.get_smoke))
    t, j = get_t(arch), get_j(arch)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    assert t.n_periods == j.n_periods and t.sub_quadratic == j.sub_quadratic


def test_registry_and_aliases_equal_the_references():
    """All ten of the JAX package's architectures, in its order, with its
    aliases; an unknown id raises."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS and sorted(treg.ARCH_IDS) == sorted(ALL_ARCHS)
    assert treg.ALIASES == jreg.ALIASES
    assert not hasattr(treg, "NOT_PORTED") and not hasattr(ttr, "NOT_PORTED")
    assert list(treg.all_configs()) == jreg.ARCH_IDS
    for alias, name in treg.ALIASES.items():
        assert treg.get_config(alias) is treg.get_config(name)
        assert treg.get_smoke(alias) is treg.get_smoke(name)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_smoke("llama_9000")


def _jax_leaves(defs) -> list:
    flat = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, jparam.ParamDef))[0]
    return sorted(("/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path),
                   d.shape, d.axes, d.init, d.scale, jnp.dtype(d.dtype).name)
                  for path, d in flat)


def _port_leaves(defs) -> list:
    return sorted((path, d.shape, d.axes, d.init, d.scale, _norm(d.dtype))
                  for path, d in tparam.tree_leaves(defs))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_width_structure_equals_the_reference(arch):
    t, j = treg.get_config(arch), jreg.get_config(arch)
    assert _port_leaves(ttr.build_model_defs(t)) == _jax_leaves(jtr.build_model_defs(j))
    for shape in ("prefill_32k", "decode_32k"):
        s = JM.SHAPES[shape]
        assert dataclasses.asdict(TM.SHAPES[shape]) == dataclasses.asdict(s)
        assert (_port_leaves(ttr.build_cache_defs(t, s.global_batch, s.seq_len))
                == _jax_leaves(jtr.build_cache_defs(j, s.global_batch, s.seq_len)))
        assert TM.cell_is_supported(t, TM.SHAPES[shape]) == JM.cell_is_supported(j, s)
    assert TM.n_params(t) == JM.n_params(j)
    assert TM.n_active_params(t) == JM.n_active_params(j)
    assert (TM.cell_is_supported(t, TM.SHAPES["long_500k"])
            == JM.cell_is_supported(j, JM.SHAPES["long_500k"]))


def test_qwen2_full_width_numbers():
    """The numbers the card's serving phase is sized by."""
    cfg = treg.get_config("qwen2_1_5b")
    assert TM.n_params(cfg) == 1_543_714_304
    kv_bytes_per_token = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2
    assert kv_bytes_per_token == 28_672


def test_qwen2_moe_full_width_numbers():
    """The numbers the card's MoE serving phase is sized by: 14.32 B
    parameters (28.6 GB in bf16), 2.69 B active per token, and per layer
    16.8 M attention, 519.0 M routed and 34.6 M shared-expert weights."""
    cfg = treg.get_config("qwen2_moe_a2_7b")
    assert TM.n_params(cfg) == 14_315_784_192
    assert TM.n_active_params(cfg) == 2_689_173_504
    layer = ttr.build_layer_defs(cfg, cfg.period[0])
    size = lambda tree: sum(math.prod(d.shape) for _, d in tparam.tree_leaves(tree))
    moe = layer["moe"]
    assert size(layer["attn"]) == 16_783_360
    assert size({k: moe[k] for k in ("w_gate", "w_up", "w_down")}) == 519_045_120
    assert size({k: v for k, v in moe.items() if k.startswith("shared")}) == 34_605_056
    assert cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2 == 196_608


def test_smoke_model_and_caches_follow_the_defs():
    """The unstacked model holds every stacked leaf's period slice, in layer
    order, and the per-layer caches are one period slice of the cache defs."""
    cfg = treg.get_smoke("gemma3_12b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(model.layers) == cfg.n_layers
    assert [b.spec for b in model.layers] == cfg.layer_specs()
    assert sum(p.numel() for p in model.parameters()) == TM.n_params(cfg)
    assert dict(model.layers[0].named_parameters()).keys() == {
        "ln1.w", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln2.w",
        "mlp.gate", "mlp.up", "mlp.down"}
    caches = TM.init_caches(cfg, 2, 16, "cpu")
    defs = ttr.build_cache_defs(cfg, 2, 16)
    assert len(caches) == cfg.n_layers
    for n, c in enumerate(caches):
        d = defs[f"pos{n % len(cfg.period)}"]["attn"]
        assert tuple(c["attn"].k.shape) == d.k.shape[1:] and c["attn"].k.dtype == d.k.dtype
        assert c["attn"].length == 0


@pytest.mark.parametrize("spec", [dict(kind="mamba"), dict(kind="mamba", moe=True),
                                  dict(kind="rwkv"), dict(kind="attn", cross=True),
                                  dict(kind="attn", causal=False)],
                         ids=["mamba", "mamba-moe", "rwkv", "cross", "encoder"])
def test_recurrent_and_cross_layer_kinds_build_the_references_defs(spec):
    """The Mamba, RWKV and cross-attention kinds (and the encoder's layer)
    build the reference's parameter and cache defs, at the widths of a
    config that serves none of them."""
    t, j = treg.get_smoke("qwen2_moe_a2_7b"), jreg.get_smoke("qwen2_moe_a2_7b")
    ts, js = ttr.LayerSpec(**spec), jtr.LayerSpec(**spec)
    assert _port_leaves(ttr.build_layer_defs(t, ts)) == _jax_leaves(jtr.build_layer_defs(j, js))
    assert (_port_leaves(ttr._layer_cache_defs(t, ts, 2, 16, 8))
            == _jax_leaves(jtr._layer_cache_defs(j, js, 2, 16, 8)))
    with pytest.raises(ValueError):
        ttr.build_layer_defs(t, ttr.LayerSpec(kind="conv"))


def test_entry_points_default_to_the_card():
    """Without a device argument the model and caches go to ``cuda``; where
    there is no card that raises rather than falling back to the CPU."""
    cfg = treg.get_smoke("qwen2_1_5b")
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert TM.init_caches(cfg, 1, 4)[0]["attn"].k.is_cuda
        assert TM.init_params(cfg, gen).embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_caches(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg, gen)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_entry_points_of_every_family_default_to_the_card(arch):
    """The recurrent, hybrid, encoder-decoder and VLM models and caches go
    to ``cuda`` without a device argument, and raise where there is none."""
    cfg = treg.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        leaves = [t for _, t in tparam.tree_leaves(TM.init_caches(cfg, 1, 4))]
        assert all(t.is_cuda for t in leaves if isinstance(t, torch.Tensor))
        assert TM.init_params(cfg, gen).embed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_caches(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(cfg, gen)


def test_serve_example_runs_on_the_cpu():
    res = run_python(f"""
        import runpy, sys
        sys.argv = ["serve_lm_torch.py", "--device", "cpu", "--arch", "stablelm_12b",
                    "--batch", "2", "--prompt-len", "8", "--tokens", "4"]
        runpy.run_path({str(pathlib.Path(REPO) / "examples" / "serve_lm_torch.py")!r},
                       run_name="__main__")
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    """)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("arch=stablelm_12b_smoke device=cpu batch=2 prompt=8 generated=4")
    assert lines[-1] == "[]"


@pytest.mark.parametrize("arch", ["rwkv6_7b", "whisper_large_v3"])
def test_serve_example_serves_the_new_families_on_the_cpu(arch):
    """The recurrent family (WKV state, no KV cache) and the
    encoder-decoder (frames drawn from the seed) through the example."""
    res = run_python(f"""
        import runpy, sys
        sys.argv = ["serve_lm_torch.py", "--device", "cpu", "--arch", {arch!r},
                    "--batch", "2", "--prompt-len", "8", "--tokens", "4"]
        runpy.run_path({str(pathlib.Path(REPO) / "examples" / "serve_lm_torch.py")!r},
                       run_name="__main__")
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    """)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith(f"arch={arch}_smoke device=cpu batch=2 prompt=8 generated=4")
    assert lines[-1] == "[]"


def test_stencil_family_configs_equal_the_reference():
    for tcells, jcells in ((trtm.SEISMIC_CELLS, jrtm.SEISMIC_CELLS),
                           (trtm.BATCHED_CELLS, jrtm.BATCHED_CELLS),
                           (tbox.BOX27_CELLS, jbox.BOX27_CELLS)):
        assert {k: dataclasses.asdict(c) for k, c in tcells.items()} == \
            {k: dataclasses.asdict(c) for k, c in jcells.items()}
    assert trtm.ops_per_meshpoint_star25() == jrtm.ops_per_meshpoint_star25()
    assert tbox.ops_per_meshpoint_box27() == jbox.ops_per_meshpoint_box27()
    assert tbox.StencilFamilyCell is trtm.StencilFamilyCell
    assert [f.name for f in dataclasses.fields(trtm.StencilFamilyCell)] == \
        [f.name for f in dataclasses.fields(jrtm.StencilFamilyCell)]
