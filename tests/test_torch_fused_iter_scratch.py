"""Scratch sizing of the fused passes' dot partials (``kernels/fused_iter``).

Each dot-producing pass of ``csrc/fused_iter.cu`` launches its own grid, one
partial per block, RHS and dot, into scratch that the Python wrapper
allocates.  A pass whose grid outgrows the query the wrapper sizes it by
writes past its buffer, so every such pass has its own block-count entry
point, ``repro_<pass>_blocks``, which returns the very expression its launch
uses for the grid, and ``kernel.py::_launch`` sizes that pass's scratch by
it.  The source is checked as text and the wrapper against a stand-in
library on the CPU: neither needs ``nvcc`` or a card.
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


class _Library:
    """Stands in for the kernel library: each pass's block query returns a
    count of its own, and every launch records the size of the buffer it
    was handed as ``partials``."""

    def __init__(self, sizes):
        self.sizes, self.partials = sizes, {}
        for i, name in enumerate(sorted(DOT_PASSES)):
            setattr(self, f"repro_{name}_blocks", lambda n, i=i: 1000 * (i + 2) + n % 7)
            setattr(self, f"repro_{name}", self._launcher(name))

    def _launcher(self, name):
        def launch(*args):
            self.partials[name] = self.sizes[args[-5]]   # ..., partials, out, n, nb, stream
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
