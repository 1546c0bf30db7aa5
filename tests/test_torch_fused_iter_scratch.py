"""Scratch sizing of the fused passes' dot partials (``kernels/fused_iter``).

Each dot-producing pass of ``csrc/fused_iter.cu`` launches its own grid, one
partial per block, RHS and dot, into scratch that the Python wrapper
allocates.  A pass whose grid outgrows the query the wrapper sizes it by
writes past its buffer, so every such pass has its own block-count entry
point, ``repro_<pass>_blocks``, which returns the very expression its launch
uses for the grid, and ``kernel.py::_launch`` sizes that pass's scratch by
it.  The source is checked as text and the wrapper against a stand-in
library on the CPU: neither needs ``nvcc`` or a card.

The group passes (K2 ``update_q_dots``, K3 ``update_xr_dots``, K4
``update_p``) walk 16-B groups on ``stream_blocks``' grid.  The wrapper
picks each launch's form (wide where n is a whole number of groups and
every pointer is on a 16-B boundary), hands it to the entry point, which
runs that form or refuses a wide one that does not hold, and counts the
element-wise launches.
"""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # one intra-op thread per test process (tests/_torch_port.py)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_iter import kernel  # noqa: E402

SOURCE = (_build.CSRC / "fused_iter.cu").read_text()
DOT_PASSES = {"update_q_dots": 2, "update_xr_dots": 2, "dot_mixed": 1}   # pass -> dots
#: the group passes: pass -> (scalars, operands, outputs, dots)
GROUP_PASSES = {"update_q_dots": (1, 3, 1, 2), "update_xr_dots": (2, 5, 2, 2),
                "update_p": (2, 3, 1, 0)}


def _entry_body(name: str) -> str:
    m = re.search(r"^int " + name + r"\(([^)]*)\)\s*\{(.*?)^\}", SOURCE, re.M | re.S)
    assert m, f"{name} is not defined in fused_iter.cu"
    return m.group(1) + "\n" + m.group(2)


def test_dot_passes_are_the_entry_points_with_partials():
    entries = re.findall(r"^int repro_(\w+)\(int dtype,[^)]*void\* partials", SOURCE, re.M | re.S)
    assert sorted(entries) == sorted(DOT_PASSES)


@pytest.mark.parametrize("name", sorted(DOT_PASSES))
def test_blocks_query_is_the_launch_grid(name):
    """repro_<pass>_blocks returns the function the pass's grid is built from."""
    query = re.search(r"^int repro_" + name + r"_blocks\(long long n\) \{ return repro::(\w+)\(n\); \}",
                      SOURCE, re.M)
    assert query, f"repro_{name}_blocks(long long n) is not defined in fused_iter.cu"
    grid = re.search(r"const dim3 grid\((\w+)\(n\), \(unsigned\)nb\);", _entry_body("repro_" + name))
    assert grid, f"repro_{name} builds no (blocks(n), B) grid"
    assert grid.group(1) == query.group(1)
    assert "sum_partials<" in _entry_body("repro_" + name) and "grid.x" in _entry_body("repro_" + name)
    assert _build.SIGNATURES["repro_" + name + "_blocks"] == [ctypes.c_longlong]


def _kernel_bodies() -> dict[str, str]:
    """Every ``__global__`` function of the source: name -> its text."""
    heads = list(re.finditer(r"^__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                             SOURCE, re.M))
    assert heads, "no __global__ function found in fused_iter.cu"
    bodies = {}
    for m in heads:
        end = re.compile(r"^\}", re.M).search(SOURCE, m.end())
        bodies[m.group(1)] = SOURCE[m.start():end.end()]
    return bodies


@pytest.mark.parametrize("name", sorted(GROUP_PASSES))
def test_group_pass_walks_16_byte_groups_on_the_stream_grid(name):
    """Each group pass checks its 32-bit group index, builds its grid from
    stream_blocks, and launches a kernel with a wide and an element-wise
    form that walks stream_groups: the form the caller's ``wide`` names,
    a wide one refused unless wide_groups holds over every operand and
    output."""
    entry = _entry_body("repro_" + name)
    assert entry.startswith("int dtype, int wide,"), entry
    assert "REPRO_CHECK_GROUPS(dtype, n);" in entry
    assert "const dim3 grid(stream_blocks(n), (unsigned)nb);" in entry
    assert f"launch_{name}<float>(grid, st, wide," in entry
    assert f"launch_{name}<bf16>(grid, st, wide," in entry
    body = _kernel_bodies()[name + "_kernel"]
    assert "stream_groups<T, Wide>(in, n," in body, body
    assert "REPRO_GRID_STRIDE" not in body
    launcher = re.search(r"^int launch_" + name + r"\(([^)]*)\)\s*\{(.*?)^\}", SOURCE,
                         re.M | re.S)
    assert launcher, f"launch_{name} is not defined in fused_iter.cu"
    n_ptrs = sum(GROUP_PASSES[name][1:3])
    refuse = re.search(r"if \(wide && !wide_groups<T>\(n, ([^)]*)\)\) "
                       r"return \(int\)cudaErrorInvalidValue;", launcher.group(2))
    assert refuse and len(refuse.group(1).split(",")) == n_ptrs, launcher.group(2)
    assert re.search(r"if \(wide\)\s+" + name + r"_kernel<T, true>", launcher.group(2))
    assert f"else\n    {name}_kernel<T, false>" in launcher.group(2)


@pytest.mark.parametrize("name", sorted([*GROUP_PASSES, "dot_mixed"]))
def test_signature_matches_the_entry_point(name):
    """``_build.SIGNATURES`` binds each pass's entry point with as many
    arguments as it takes, ints where it takes ints: the group passes' form
    (``int wide``) second, after the dtype."""
    m = re.search(r"^int repro_" + name + r"\(([^)]*)\)", SOURCE, re.M)
    assert m, f"repro_{name} is not defined in fused_iter.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    want = [ctypes.c_int if p.startswith("int ") else
            ctypes.c_longlong if p.startswith("long long ") else ctypes.c_void_p for p in params]
    assert _build.SIGNATURES["repro_" + name] == want
    assert (params[1] == "int wide") == (name in GROUP_PASSES)


def test_no_kernel_walks_grid_stride():
    """No pass walks its vectors one element a thread a step any more."""
    bodies = _kernel_bodies()
    assert sorted(bodies) == ["dot_mixed_kernel", "update_p_kernel", "update_q_dots_kernel",
                              "update_xr_dots_kernel"]
    assert not [k for k, body in bodies.items() if "REPRO_GRID_STRIDE" in body]


class _Library:
    """Stands in for the kernel library: each pass's block query returns a
    count of its own, every launch records the size of the buffer it was
    handed as ``partials``, and each group pass's launch the form it was
    handed (``wide``, after the dtype)."""

    def __init__(self, sizes):
        self.sizes, self.partials, self.forms = sizes, {}, {}
        for i, name in enumerate(sorted(DOT_PASSES)):
            setattr(self, f"repro_{name}_blocks", lambda n, i=i: 1000 * (i + 2) + n % 7)
        for name in sorted({*DOT_PASSES, *GROUP_PASSES}):
            setattr(self, f"repro_{name}", self._launcher(name))

    def _launcher(self, name):
        def launch(*args):
            if DOT_PASSES.get(name):
                self.partials[name] = self.sizes[args[-5]]   # ..., partials, out, n, nb, stream
            if name in GROUP_PASSES:
                self.forms.setdefault(name, []).append(args[1])
            return 0
        return launch


@pytest.fixture
def fake_library(monkeypatch):
    sizes = {}
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        sizes[t.data_ptr()] = t.numel()
        return t

    lib = _Library(sizes)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernel, "launches", dict(kernel.launches))   # no count leaks out
    monkeypatch.setattr(kernel, "element_wise_launches", dict(kernel.element_wise_launches))
    return lib


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(DOT_PASSES))
def test_launch_sizes_scratch_by_the_pass_query(fake_library, name, batched):
    n_in = {"update_q_dots": 3, "update_xr_dots": 5, "dot_mixed": 2}[name]
    n_out = {"update_q_dots": 1, "update_xr_dots": 2, "dot_mixed": 0}[name]
    n_scalars = {"update_q_dots": 1, "update_xr_dots": 2, "dot_mixed": 0}[name]
    nb, n = (3, 1001) if batched else (1, 1001)
    vectors = [torch.zeros((nb, n) if batched else (n,)) for _ in range(n_in)]
    scalars = [torch.ones(nb) if batched else torch.tensor(1.0) for _ in range(n_scalars)]
    outs, dots = kernel._launch(name, batched, scalars, vectors, n_out, DOT_PASSES[name])
    blocks = getattr(fake_library, f"repro_{name}_blocks")(n)
    assert fake_library.partials[name] == nb * blocks * DOT_PASSES[name]
    assert len(outs) == n_out
    assert dots.shape == ((DOT_PASSES[name], nb) if batched else (DOT_PASSES[name],))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["whole_groups", "odd_n", "off_16_bytes"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(GROUP_PASSES))
def test_element_wise_launches_count_the_element_wise_form(fake_library, name, batched, case,
                                                          dtype):
    """An odd n or operands that start off a 16-B boundary (``buf[1:]``
    views) launch the element-wise form (``wide`` 0) and count it; aligned
    whole groups launch the wide form and count none.  Every launch counts
    in ``launches`` either way."""
    n_scalars, n_in, n_out, n_dots = GROUP_PASSES[name]
    nb, n = (3 if batched else 1), (1001 if case == "odd_n" else 1000)   # 1000: 8 | n
    shape = (nb, n) if batched else (n,)

    def operand():
        if case != "off_16_bytes":
            return torch.zeros(shape, dtype=dtype)
        return torch.zeros(nb * n + 1, dtype=dtype)[1:].view(shape)

    vectors = [operand() for _ in range(n_in)]
    assert all((t.data_ptr() % 16 != 0) == (case == "off_16_bytes") for t in vectors)
    scalars = [torch.ones(nb) if batched else torch.tensor(1.0) for _ in range(n_scalars)]
    key = name + "_batched" if batched else name
    kernel._launch(name, batched, scalars, vectors, n_out, n_dots)
    kernel._launch(name, batched, scalars, vectors, n_out, n_dots)
    assert kernel.launches[key] == 2
    wide = int(case == "whole_groups")
    assert fake_library.forms == {name: [wide, wide]}
    assert kernel.element_wise_launches[key] == (0 if wide else 2)
    assert sum(kernel.element_wise_launches.values()) == kernel.element_wise_launches[key]
