"""Device-sized client waves for the cross-device engine (port of
``fedml_tpu/device_cohort``)."""

from fedml_tpu_torch.device_cohort.waves import (  # noqa: F401
    Wave, WaveAdmission, make_scaffold_wave_fn, make_wave_fn, plan_waves)
