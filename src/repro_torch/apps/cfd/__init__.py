"""SIMPLE CFD application (paper §VI Alg. 2) on the solver stack.

Counterpart of ``repro/apps/cfd``; layers (each its own module):

* :mod:`~repro_torch.apps.cfd.grid`     — MAC-grid storage, configs, conversions;
* :mod:`~repro_torch.apps.cfd.momentum` — u/v momentum-system formation (upwind +
  diffusion, under-relaxation, the f32 clamp-before-cast rule);
* :mod:`~repro_torch.apps.cfd.pressure` — continuity defect + p'-system formation;
* :mod:`~repro_torch.apps.cfd.driver`   — SIMPLE outer loop over the operator/
  solver/precond registries, steady + transient (checkpointed) drivers.

``core.simple_cfd`` re-exports the legacy seed surface from here.
"""

from repro_torch.apps.cfd.grid import (  # noqa: F401
    CavityConfig, CFDConfig, cell_state, centerline_u, from_staggered,
    to_staggered,
)
from repro_torch.apps.cfd.driver import (  # noqa: F401
    SolverOptions, TransientConfig, make_step_fn, make_transient_step,
    run_transient, simple_step, solve_cavity, solve_steady,
)

__all__ = [
    "CFDConfig", "CavityConfig", "SolverOptions", "TransientConfig",
    "cell_state", "centerline_u", "from_staggered", "to_staggered",
    "make_step_fn", "make_transient_step", "run_transient", "simple_step",
    "solve_cavity", "solve_steady",
]
