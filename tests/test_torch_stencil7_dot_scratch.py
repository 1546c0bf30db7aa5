"""Scratch sizing of the SpMV+dot kernel's partials (``kernels/stencil_nd/fused.py``).

K6 (``csrc/stencil7_dot.cu``) launches the stencil kernel's grid of (y, z)
tiles by x segments, cut by ``kernel.py:launch_plan``, and every block
writes one partial per dot into scratch that the Python wrapper allocates.
The wrapper sizes that scratch by the plan's block count and passes the
count to the entry point, which refuses a plan whose grid is not that many
blocks.  The source is checked as text and the wrapper against a stand-in
library on the CPU: neither needs ``nvcc`` or a card.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stencil_nd import fused  # noqa: E402
from repro_torch.kernels.stencil_nd.kernel import launch_plan  # noqa: E402

SOURCE = (_build.CSRC / "stencil7_dot.cu").read_text()
SHAPES = [(48, 48, 32), (37, 29, 17), (1, 29, 17), (37, 1, 17), (37, 29, 1), (3, 7, 17),
          (20, 40, 300)]


def _function(signature_start: str) -> str:
    m = re.search(r"^" + re.escape(signature_start) + r".*?^\}", SOURCE, re.M | re.S)
    assert m, f"{signature_start} is not defined in stencil7_dot.cu"
    return m.group(0)


def test_entry_point_checks_the_scratch_against_its_grid():
    run = _function("static int run(")
    assert re.search(r"const long long ntz = \(z \+ tz - 1\) / tz, nty = \(by \+ ty - 1\) / ty;",
                     run)
    assert "const long long segments = (bx + seg_len - 1) / seg_len;" in run
    assert re.search(r"if \(nblk != nty \* ntz \* segments\b[^)]*\) "
                     r"return \(int\)cudaErrorInvalidValue;", run)
    launch = _function("static int launch(")
    assert "const dim3 grid((unsigned)(nty * p.ntz), (unsigned)segments);" in launch
    assert re.search(r"sum_partials<ND><<<1, kThreads, 0, stream>>>\(p\.part, \(int\)nblk,", launch)


def test_every_block_writes_its_partial():
    """The partial's index is the block's place in the grid, and no block
    returns before writing it (the only return is the staging address's
    lambda); no atomics (the sums repeat bit for bit)."""
    body = SOURCE[SOURCE.index("stencil7_dot_kernel(const DotParams p) {"):
                  SOURCE.index("static int launch(")]
    assert "p.part[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * ND + d] = v[d];" in body
    returns = re.findall(r"[^\n]*\breturn\b[^\n]*", body)
    assert returns and all("auto src_of = [&](int pp) { return " in line for line in returns)
    assert "atomicAdd" not in SOURCE


class _Library:
    """Stands in for the kernel library: the entry point records its
    arguments and the size of the buffer it was handed as ``partials``, and
    answers as the C entry point does when the block count is not its grid's."""

    def __init__(self, sizes):
        self.sizes, self.calls = sizes, []

    def repro_stencil7_dot(self, storage, accum, vp, w, cf_ptrs, n_dots, bx, by, z, u, ty, tz,
                           seg_len, nblk, partials, out, stream):
        grid = -(-by // ty) * -(-z // tz) * -(-bx // seg_len)
        self.calls.append(dict(w=w, n_dots=n_dots, shape=(bx, by, z), ty=ty, tz=tz,
                               seg_len=seg_len, nblk=nblk, grid=grid,
                               partials=self.sizes[partials], out=self.sizes[out]))
        return 0 if nblk == grid else 1

    def repro_error_string(self, code):
        return b"invalid argument"


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
    monkeypatch.setattr(fused, "launches", dict(fused.launches))   # no count leaks out
    return lib


@pytest.mark.parametrize("two_dots,ring_w", [(False, False), (True, False), (True, True)],
                         ids=["one_dot", "two_dots_w_given", "two_dots"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_sizes_scratch_by_the_plan(fake_library, shape, dtype, two_dots, ring_w):
    """The one-dot variant reads w, the two-dot variant takes it from the
    ring (w=None); the two-dot variant refuses a w of its own before any
    launch."""
    vp = torch.zeros(tuple(s + 2 for s in shape), dtype=dtype)
    w = None if ring_w else torch.zeros(shape, dtype=dtype)
    cfs = [torch.zeros(shape, dtype=dtype) for _ in range(6)]
    if two_dots and w is not None:
        with pytest.raises(ValueError, match="two-dot variant takes w=None"):
            fused.stencil7_dots_padded(vp, w, cfs, two_dots=True)
        assert not fake_library.calls and fused.launches["stencil7_dot"] == 0
        return
    u, d1, d2 = fused._launch(vp, w, cfs, two_dots, torch.float32)
    (call,) = fake_library.calls
    plan = launch_plan(shape, 1, 6, 1, vp.element_size())
    n_dots = 2 if two_dots else 1
    assert (call["ty"], call["tz"], call["seg_len"]) == (plan.ty, plan.tz, plan.seg_len)
    assert call["nblk"] == call["grid"] == plan.blocks
    assert call["partials"] == plan.blocks * n_dots and call["out"] == n_dots
    assert call["n_dots"] == n_dots and (call["w"] is None) == ring_w
    assert tuple(u.shape) == shape and (d2 is None) == (not two_dots)
    assert fused.launches["stencil7_dot"] == 1


def test_launch_refuses_what_the_kernel_does_not_take(fake_library):
    vp = torch.zeros((6, 6, 6))
    cfs = [torch.zeros((4, 4, 4)) for _ in range(6)]
    with pytest.raises(ValueError, match="w and the fields"):
        fused._launch(vp, torch.zeros((4, 4, 5)), cfs, False, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        fused._launch(vp, torch.zeros((4, 4, 4), dtype=torch.bfloat16), cfs, False,
                      torch.float32)
    with pytest.raises(ValueError, match="6 fields"):
        fused._launch(vp, None, cfs[:5], True, torch.float32)
    with pytest.raises(ValueError, match="one-dot variant takes w"):
        fused.stencil7_dots_padded(vp, None, cfs, two_dots=False)
    with pytest.raises(ValueError, match="two-dot variant takes w=None"):
        fused.stencil7_dots_padded(vp, torch.zeros((4, 4, 4)), cfs, two_dots=True)
    assert not fake_library.calls
