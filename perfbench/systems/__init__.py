"""Systems under test, one module each, named by a configuration's ``system`` key.

A system module builds a cell's inputs from the seed, makes one timed call of the
program per :meth:`step`, and judges what the window produced against the
reference in :meth:`numbers`.
"""
