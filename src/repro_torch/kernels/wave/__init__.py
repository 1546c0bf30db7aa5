from repro_torch.kernels.wave.kernel import launch_plan, wave_leapfrog  # noqa: F401
from repro_torch.kernels.wave.ref import wave_leapfrog_ref  # noqa: F401
