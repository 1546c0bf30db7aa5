"""The compulsory byte counts of the two roofline metrics, held to values
worked out by hand at one small shape, and below what today's kernels move
(``chip_smoke.py:iteration_bytes``, which counts the zero pads and the
separate ``q_in`` pass)."""

import importlib.util
import math
from pathlib import Path

import pytest

from perfbench.metrics import iter_roofline, spmv_roofline

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (8, 6, 5)                  # 240 points
N = math.prod(SHAPE)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_fields, itemsize, words", [
    (6, 2, 1 + 6 + 1),             # star7: read v, 6 fields, write u
    (24, 2, 1 + 24 + 1),           # a 25-point star
    (6, 4, 1 + 6 + 1),
])
def test_spmv_bytes_by_hand(n_fields, itemsize, words):
    assert spmv_roofline.spmv_bytes(N, n_fields, itemsize) == words * N * itemsize


@pytest.mark.parametrize("n_fields, words", [
    # sweep A: r,p,s,r0 + F in; p',s' out.  B: r,s' + F in; y out.  C: x,p',r,s',y,r0 in; x',r' out
    (6, (4 + 6 + 2) + (2 + 6 + 1) + (6 + 0 + 2)),            # 29
    (24, (4 + 24 + 2) + (2 + 24 + 1) + (6 + 0 + 2)),         # 65
])
def test_iteration_bytes_by_hand(n_fields, words):
    assert iter_roofline.iteration_bytes("bicgstab", N, n_fields, 2) == words * N * 2


@pytest.mark.parametrize("itemsize", [2, 4])
def test_counts_below_what_todays_kernels_move(itemsize):
    moved = _chip_smoke().iteration_bytes(SHAPE, itemsize, radius=1, n_off=6, nrhs=1)
    assert iter_roofline.iteration_bytes("bicgstab", N, 6, itemsize) < moved
    # today's K1 reads the zero-padded input: more than the compulsory read
    n_pad = math.prod(s + 2 for s in SHAPE)
    k1 = (n_pad + 6 * N + N) * itemsize
    assert spmv_roofline.spmv_bytes(N, 6, itemsize) < k1


def test_paper_mesh_iteration_bytes():
    """29 words a point at 600x595x1536 in bf16: 31.80 GB, 9.49 ms at 3.35 TB/s."""
    b = iter_roofline.iteration_bytes("bicgstab", 600 * 595 * 1536, 6, 2)
    assert b == 29 * 600 * 595 * 1536 * 2 == 31_804_416_000
    assert b / 3.35e12 == pytest.approx(9.494e-3, abs=5e-6)
