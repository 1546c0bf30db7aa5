"""``examples/train_lm_torch.py`` on the CPU: the ~8M-parameter demo model
trains on the synthetic-motif stream with a failure injected half way (before
its first checkpoint, so the runner restarts from the initial state), and
the script's own assertion holds: the mean loss of the last 20 recorded
steps is more than 0.5 below that of the first 20."""

import os
import re

import pytest

pytest.importorskip("torch")

from _torch_port import REPO, run_python  # noqa: E402

EXAMPLE = os.path.join(REPO, "examples", "train_lm_torch.py")


def test_train_example_learns_and_survives_a_restart():
    res = run_python(f"""
        import runpy, sys
        sys.argv = [{EXAMPLE!r}, "--device", "cpu", "--steps", "60", "--seq", "32",
                    "--batch", "2"]
        runpy.run_path({EXAMPLE!r}, run_name="__main__")
    """, env_extra={"OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "model: demo_8m" in out and " params on cpu" in out
    m = re.search(r"(\d+) recorded steps in \d+s \(restarts survived: 1\)", out)
    assert m and int(m.group(1)) == 90, out       # steps 0-29 run twice
    m = re.search(r"first-20-avg (\S+) -> last-20-avg (\S+)", out)
    assert m and float(m.group(2)) < float(m.group(1)) - 0.5, out
    assert "OK: loss dropped; checkpoint/restart exercised" in out
