from phendiff_tpu_torch.core.device import resolve_device  # noqa: F401
from phendiff_tpu_torch.core.precision import Policy  # noqa: F401
from phendiff_tpu_torch.core.scheduler import (  # noqa: F401
    NoiseSchedule,
    SchedulerConfig,
    add_noise,
    ddim_inverse_step,
    ddim_step,
    inference_timesteps,
    inversion_timestep_pairs,
    make_schedule,
    predict_x0_eps,
    snr,
    timestep_pairs,
    velocity,
)
