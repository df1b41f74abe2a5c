from .networks import AMPSeptValueNet, ValuePoseNet  # noqa: F401
from .running_norm import RunningNorm  # noqa: F401
