"""Stencil-family operators (paper §IV), counterpart of ``repro/core/stencil.py``.

The paper's matrix ``A`` has seven nonzero diagonals; after Jacobi
normalization the main diagonal is all ones, so only the off-diagonals are
stored, one mesh-shaped tensor each.  A :class:`StencilSpec` (pattern star or
box, radius r) names the family member; diagonal names are canonical
(``xp``..``zm`` for the radius-1 star, ``xp2`` for deeper star offsets,
``d1_-1_0`` for box offsets), so :class:`StencilCoeffs` is self-describing.

Boundaries are zero-Dirichlet: a shift that crosses the mesh edge reads 0.

The deterministic generators (:func:`poisson`, :func:`convection_diffusion`,
:func:`high_order_star`) reproduce the JAX package's values exactly; the
random ones take a :class:`torch.Generator` and so draw other numbers than
``jax.random`` from the same seed.  Systems built by the JAX package cross
over with :meth:`StencilCoeffs.from_numpy`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import re

import numpy as np
import torch

from repro_torch.core.precision import F32, Policy
from repro_torch.device import tensor_from_numpy

# Order matters and is shared with the CUDA kernel and to_dense.
DIAGS_3D = ("xp", "xm", "yp", "ym", "zp", "zm")
DIAGS_2D = ("xp", "xm", "yp", "ym")

# Offset (in mesh coordinates) of the neighbor each diagonal reads.
OFFSETS = {
    "xp": (1, 0, 0), "xm": (-1, 0, 0),
    "yp": (0, 1, 0), "ym": (0, -1, 0),
    "zp": (0, 0, 1), "zm": (0, 0, -1),
}

_AXES = "xyz"
_STAR_NAME = re.compile(r"^([xyz])([pm])(\d*)$")


def offset_name(off: tuple[int, ...]) -> str:
    """Canonical diagonal name of a neighbor offset (see module docstring)."""
    nz = [(i, o) for i, o in enumerate(off) if o != 0]
    if len(nz) == 1:
        ax, o = nz[0]
        base = f"{_AXES[ax]}{'p' if o > 0 else 'm'}"
        return base if abs(o) == 1 else f"{base}{abs(o)}"
    return "d" + "_".join(str(o) for o in off)


def name_offset(name: str, ndim: int = 3) -> tuple[int, ...]:
    """Inverse of :func:`offset_name`."""
    if name.startswith("d"):
        off = tuple(int(t) for t in name[1:].split("_"))
        if len(off) != ndim:
            raise ValueError(f"offset name {name!r} is {len(off)}-D, mesh is {ndim}-D")
        return off
    m = _STAR_NAME.match(name)
    if not m:
        raise ValueError(f"unrecognized diagonal name {name!r}")
    ax = _AXES.index(m.group(1))
    dist = int(m.group(3) or 1) * (1 if m.group(2) == "p" else -1)
    if ax >= ndim:
        raise ValueError(f"diagonal {name!r} names axis {ax} on a {ndim}-D mesh")
    return tuple(dist if i == ax else 0 for i in range(ndim))


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A stencil shape: ``star`` (axis-aligned arms) or ``box`` (full cube)."""

    pattern: str            # "star" | "box"
    radius: int
    ndim: int = 3

    def __post_init__(self):
        if self.pattern not in ("star", "box"):
            raise ValueError(f"pattern must be 'star' or 'box', got {self.pattern!r}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")

    @functools.cached_property
    def offsets(self) -> tuple[tuple[int, ...], ...]:
        """Neighbor offsets (center excluded), in canonical order: star is
        axis-major, then distance, ``+`` before ``-``; box is lexicographic."""
        if self.pattern == "star":
            offs = []
            for ax in range(self.ndim):
                for dist in range(1, self.radius + 1):
                    for sign in (+1, -1):
                        offs.append(tuple(sign * dist if i == ax else 0
                                          for i in range(self.ndim)))
            return tuple(offs)
        rng = range(-self.radius, self.radius + 1)
        return tuple(o for o in itertools.product(*([rng] * self.ndim)) if any(o))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(offset_name(o) for o in self.offsets)

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def n_points(self) -> int:
        """Stencil points including the center (7, 13, 25, 27, ...)."""
        return self.n_offsets + 1

    @property
    def name(self) -> str:
        return f"{self.pattern}{self.n_points}"

    @property
    def needs_corners(self) -> bool:
        """True iff the halo exchange must fill edge/corner halo regions."""
        return self.pattern == "box"


STAR7 = StencilSpec("star", 1, 3)
STAR13 = StencilSpec("star", 2, 3)
STAR25 = StencilSpec("star", 4, 3)
BOX27 = StencilSpec("box", 1, 3)

#: CLI-facing registry; launch/solve.py and the configs key off this.
SPECS = {s.name: s for s in (STAR7, STAR13, STAR25, BOX27)}


def get_spec(name: str) -> StencilSpec:
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"unknown stencil {name!r}; have {sorted(SPECS)}") from None


def spec_of(names, ndim: int = 3) -> StencilSpec:
    """The spec a set of diagonal names was generated from."""
    offs = [name_offset(n, ndim) for n in names]
    radius = max(max(abs(o) for o in off) for off in offs)
    box = any(sum(o != 0 for o in off) > 1 for off in offs)
    return StencilSpec("box" if box else "star", radius, ndim)


@dataclasses.dataclass
class StencilCoeffs:
    """Off-diagonal coefficient fields of a stencil matrix.

    ``diags[name][i,j,k]`` multiplies ``v[(i,j,k) + offset(name)]`` in row
    ``(i,j,k)`` of ``A @ v``.  ``diag`` is the main diagonal: ``None`` means
    the family's unit diagonal (the paper's Jacobi-normalized form); a stored
    tensor makes a *raw* operator (e.g. :func:`heterogeneous_poisson`).
    """

    diags: dict[str, torch.Tensor]
    diag: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, diags: dict[str, np.ndarray], diag: np.ndarray | None = None,
                   *, device: str | torch.device) -> "StencilCoeffs":
        """Carry a system over from numpy (e.g. the JAX package's
        coefficients, ``{name: np.asarray(a)}``) without changing a bit."""
        return cls({n: tensor_from_numpy(a, device) for n, a in diags.items()},
                   diag=None if diag is None else tensor_from_numpy(diag, device))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.diags)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(next(iter(self.diags.values())).shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> StencilSpec:
        """The :class:`StencilSpec` implied by the diagonal names."""
        return spec_of(self.names, self.ndim)

    def ordered_items(self) -> list[tuple[str, torch.Tensor]]:
        """(name, coefficient) pairs in the spec's canonical offset order.

        Every apply path (``apply_ref``, the halo applies, the CUDA kernel's
        argument order) accumulates terms in THIS order: the invariant behind
        bitwise identity across schedules and backends.
        """
        return [(n, self.diags[n]) for n in self.spec.names if n in self.diags]

    def astype(self, dtype: torch.dtype) -> "StencilCoeffs":
        return StencilCoeffs(
            {k: v.to(dtype) for k, v in self.diags.items()},
            diag=None if self.diag is None else self.diag.to(dtype))

    def to(self, device: str | torch.device) -> "StencilCoeffs":
        """The same fields on ``device``, bits unchanged."""
        return StencilCoeffs(
            {k: v.to(device) for k, v in self.diags.items()},
            diag=None if self.diag is None else self.diag.to(device))


def _shift(v: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """v shifted so result[i] = v[i + offset] along ``axis``; zero fill."""
    if offset == 0:
        return v
    out = torch.zeros_like(v)
    n = v.shape[axis]
    if abs(offset) >= n:
        return out
    if offset > 0:
        out.narrow(axis, 0, n - offset).copy_(v.narrow(axis, offset, n - offset))
    else:
        out.narrow(axis, -offset, n + offset).copy_(v.narrow(axis, 0, n + offset))
    return out


def _shift_nd(v: torch.Tensor, off: tuple[int, ...]) -> torch.Tensor:
    """v shifted by a (possibly multi-axis) offset, zero fill at the edges."""
    for axis, o in enumerate(off):
        if o != 0:
            v = _shift(v, axis, o)
    return v


def apply_ref(coeffs: StencilCoeffs, v: torch.Tensor, *, policy: Policy = F32) -> torch.Tensor:
    """Reference u = A v in one address space: the oracle for everything else.

    Products and accumulating adds run in ``policy.compute``, one rounding
    per op, terms in ``coeffs.ordered_items()`` order; the unit diagonal
    contributes ``v`` directly.  ``v`` may carry a leading batch axis.
    """
    c = policy.compute
    nb = v.ndim - coeffs.ndim
    if coeffs.diag is None:
        u = v.to(c)
    else:
        u = coeffs.diag.to(c) * v.to(c)
    for name, cf in coeffs.ordered_items():
        off = (0,) * nb + name_offset(name, coeffs.ndim)
        u = u + cf.to(c) * _shift_nd(v, off).to(c)
    return u.to(policy.storage)


def to_dense(coeffs: StencilCoeffs) -> np.ndarray:
    """Materialize A as a dense (N, N) float64 matrix (small meshes only)."""
    shape = coeffs.shape
    n = int(np.prod(shape))
    if coeffs.diag is None:
        A = np.eye(n, dtype=np.float64)
    else:
        A = np.diag(coeffs.diag.detach().cpu().double().numpy().ravel())
    idx = np.arange(n).reshape(shape)
    for name, cf in coeffs.diags.items():
        cf = cf.detach().cpu().double().numpy()
        off = name_offset(name, len(shape))
        src = idx
        for ax, o in enumerate(off):
            src = np.roll(src, -o, axis=ax)
        valid = np.ones(shape, dtype=bool)     # rows whose neighbor is inside
        for ax, o in enumerate(off):
            sl = [slice(None)] * len(shape)
            if o >= 1:
                sl[ax] = slice(-o, None)
                valid[tuple(sl)] = False
            elif o <= -1:
                sl[ax] = slice(0, -o)
                valid[tuple(sl)] = False
        A[idx[valid].ravel(), src[valid].ravel()] += cf[valid].ravel()
    return A


# ---------------------------------------------------------------------------
# Problem generators
# ---------------------------------------------------------------------------

def _default_spec(shape, spec: StencilSpec | None) -> StencilSpec:
    if spec is None:
        return StencilSpec("star", 1, len(shape))
    if spec.ndim != len(shape):
        raise ValueError(f"spec is {spec.ndim}-D but mesh shape {shape} is {len(shape)}-D")
    return spec


def poisson(shape: tuple[int, ...], dtype=torch.float32,
            spec: StencilSpec | None = None, *, device) -> StencilCoeffs:
    """Jacobi-normalized constant-coefficient Laplacian: unit diagonal,
    off-diagonals ``-1/n_offsets``, on ``device``."""
    spec = _default_spec(shape, spec)
    c = -1.0 / spec.n_offsets
    return StencilCoeffs({n: torch.full(shape, c, dtype=dtype, device=device)
                          for n in spec.names})


def random_nonsymmetric(generator: torch.Generator, shape: tuple[int, ...],
                        dtype=torch.float32, *, dominance: float = 1.25,
                        spec: StencilSpec | None = None) -> StencilCoeffs:
    """Random nonsymmetric strictly diagonally dominant stencil.

    Off-diagonal magnitudes are uniform in [0.05, 1) and scaled so they sum
    to ``1/dominance`` per row; signs are random.  Drawn on the generator's
    device.
    """
    names = _default_spec(shape, spec).names
    dev = generator.device
    mags = {n: 0.05 + 0.95 * torch.rand(shape, generator=generator, device=dev)
            for n in names}
    total = sum(mags.values())
    signs = {n: torch.where(torch.rand(shape, generator=generator, device=dev) < 0.5,
                            1.0, -1.0) for n in names}
    return StencilCoeffs(
        {n: (signs[n] * mags[n] / (dominance * total)).to(dtype) for n in names})


def convection_diffusion(shape: tuple[int, ...], dtype=torch.float32, *,
                         peclet: float = 5.0, device) -> StencilCoeffs:
    """Upwinded convection-diffusion operator, Jacobi normalized: diffusion
    -1 per face, constant velocity (1, 0.5, 0.25) upwinded at cell Peclet
    number ``peclet``, on ``device``."""
    ndim = len(shape)
    vel = (1.0, 0.5, 0.25)[:ndim]
    names = DIAGS_3D if ndim == 3 else DIAGS_2D
    raw: dict[str, float] = {}
    diag = 0.0
    for ax, (plus, minus) in enumerate(zip(names[0::2], names[1::2])):
        conv = peclet * vel[ax]
        raw[plus] = -1.0             # first-order upwind biases the -ax neighbor
        raw[minus] = -1.0 - conv
        diag += 2.0 + conv
    return StencilCoeffs({n: torch.full(shape, raw[n] / diag, dtype=dtype, device=device)
                          for n in names})


def heterogeneous_poisson(generator: torch.Generator, shape: tuple[int, ...],
                          dtype=torch.float32, *, contrast: float = 2.0,
                          spec: StencilSpec | None = None) -> StencilCoeffs:
    """Raw (non-normalized) variable-coefficient diffusion operator.

    Log-normal cell diffusivity ``k = exp(contrast * N(0,1))``; each coupling
    is the face average ``(k_i + k_j)/2`` with edge-replicated boundary faces,
    and the stored main diagonal is the row sum of the couplings.
    """
    spec = _default_spec(shape, spec)
    k = torch.exp(contrast * torch.randn(shape, generator=generator,
                                         device=generator.device))

    def shift_edge(a, off):
        for axis, o in enumerate(off):
            if o == 0:
                continue
            n = a.shape[axis]
            idx = torch.arange(n, device=a.device) + o
            a = a.index_select(axis, idx.clamp(0, n - 1))
        return a

    couplings = {offset_name(o): (k + shift_edge(k, o)) / 2.0 for o in spec.offsets}
    diag = sum(couplings.values())
    return StencilCoeffs({n: (-c).to(dtype) for n, c in couplings.items()},
                         diag=diag.to(dtype))


# Central-difference second-derivative weights a_k (k = 1..r) of order 2r;
# a_0 is the center weight.  r=4 is the 8th-order arm of the 25-point
# seismic-RTM stencil.
_FD2_WEIGHTS = {
    1: (-2.0, (1.0,)),
    2: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
    3: (-49.0 / 18.0, (3.0 / 2.0, -3.0 / 20.0, 1.0 / 90.0)),
    4: (-205.0 / 72.0, (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)),
}


def high_order_star(shape: tuple[int, ...], radius: int = 4, dtype=torch.float32,
                    *, dominance: float = 1.25, device) -> StencilCoeffs:
    """High-order star operator ``I - theta * Laplacian_2r``, Jacobi
    normalized, with ``theta`` set so the off-diagonal row sum is
    ``1/dominance``, on ``device``.

    An implicit-step system of the repo's own construction (the dominance
    and the solve are not the source's): the seismic source workload,
    Jacquelin, Araya-Polo and Meng's explicit 25-point time stepping of the
    acoustic wave equation, is ``core/wave.py``."""
    if radius not in _FD2_WEIGHTS:
        raise ValueError(f"radius must be in {sorted(_FD2_WEIGHTS)}, got {radius}")
    spec = StencilSpec("star", radius, len(shape))
    _, arm = _FD2_WEIGHTS[radius]
    total = len(shape) * 2 * sum(abs(a) for a in arm)
    scale = 1.0 / (dominance * total)
    diags = {}
    for off in spec.offsets:
        dist = max(abs(o) for o in off)
        diags[offset_name(off)] = torch.full(shape, -arm[dist - 1] * scale,
                                             dtype=dtype, device=device)
    return StencilCoeffs(diags)


def rhs_for_solution(coeffs: StencilCoeffs, x_true: torch.Tensor) -> torch.Tensor:
    """b = A @ x_true in f32, for manufactured tests."""
    return apply_ref(coeffs.astype(torch.float32), x_true.to(torch.float32))


# ---------------------------------------------------------------------------
# Op counts (paper Table I), for the performance model and roofline lines
# ---------------------------------------------------------------------------

def flops_per_point(ndim: int = 3) -> int:
    """SpMV flops per meshpoint: 6 mul + 6 add (3D, unit diagonal) = 12.

    Matches Table I: Matvec x2 per iteration = 24 of the 44 ops/meshpoint.
    """
    return 2 * (2 * ndim)


def words_per_point(ndim: int = 3) -> int:
    """Memory words touched per meshpoint per SpMV: 6 coeffs + v + u."""
    return 2 * ndim + 2


def spec_flops_per_point(spec: StencilSpec) -> int:
    """SpMV flops per meshpoint for any family member: mul+add per offset.

    star7 => 12 (Table I's 24/2), star25 => 48, box27 => 52.
    """
    return 2 * spec.n_offsets


def spec_words_per_point(spec: StencilSpec) -> int:
    """Memory words touched per meshpoint per SpMV: coeffs + v + u."""
    return spec.n_offsets + 2


def halo_words_per_spmv(spec: StencilSpec, block: tuple[int, ...],
                        split_axes: tuple[int, ...] = (0, 1)) -> int:
    """Words exchanged per SpMV by one rank: depth-r slabs on split axes.

    Counts both directions; for box stencils the sequential corner-carrying
    exchange also ships the already-received halo of earlier axes.
    """
    r = spec.radius
    words = 0
    padded = list(block)
    for ax in split_axes:
        slab = r
        for i, n in enumerate(padded):
            if i != ax:
                slab *= n
        words += 2 * slab
        if spec.needs_corners:
            padded[ax] += 2 * r
    return words
