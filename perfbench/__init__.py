"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that measures or judges lives here, outside the program: the traffic, the
inputs, the reference solvers that decide ``correct``, the byte counts of the
rooflines and the table of peaks.
"""
