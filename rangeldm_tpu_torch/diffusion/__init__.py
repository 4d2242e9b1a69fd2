from rangeldm_tpu_torch.diffusion.schedule import (  # noqa: F401
    Schedule, ScheduleConfig,
)
