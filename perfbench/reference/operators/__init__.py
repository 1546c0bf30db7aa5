"""One file per operator, found by the name a configuration gives under
``operator.kind``.  Each defines ``fields(shape, params, device)``: the
off-diagonal coefficient fields of the Jacobi-normalised operator (unit main
diagonal), one float32 tensor per point, keyed by canonical offset name."""
