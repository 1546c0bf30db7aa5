from repro_torch.runtime.runner import FaultTolerantRunner, RunnerConfig  # noqa: F401
