"""The paper's solver stack on PyTorch: stencil operators, the halo layer,
the operator backends, the solver registry and the solve entry points."""
