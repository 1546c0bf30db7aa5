"""Plain PyTorch reference of the benchmark's systems.

Imports nothing of the program under test: the coefficient formulas, the
stencil apply and the Krylov solvers here are written from the sources
(Rocki et al., SC20, for the operator and BiCGStab) and
are what ``correct`` is decided against.
"""
