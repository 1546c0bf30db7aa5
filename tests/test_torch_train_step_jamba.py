"""Training parity with the JAX package for the Mamba + attention + MoE hybrid
(Jamba), at smoke width in f32: ``loss_fn``'s value and every gradient leaf,
and one whole ``train_step`` (its loss, metrics, moments and parameters),
with the tolerances of ``tests/_torch_train.py``."""

import pytest

pytest.importorskip("torch")

from _torch_train import step_test  # noqa: E402

test_loss_grads_and_train_step_match_jax = step_test(["jamba_v0_1_52b"])
