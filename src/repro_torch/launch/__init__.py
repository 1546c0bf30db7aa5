"""Entry points: the rank mesh and the solver CLI."""
