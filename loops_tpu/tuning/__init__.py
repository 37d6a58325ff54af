"""Per-device kernel knobs and published peaks."""
from loops_tpu.tuning.launch_box import LaunchParams, launch_params  # noqa: F401
