"""device_idle.rollout: the share of the stretch with no device operation,
in the rollout cells
(``portbench.readers.device_idle``)."""
from portbench.readers import device_idle as read  # noqa: F401
