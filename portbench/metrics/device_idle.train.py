"""device_idle.train: the share of the stretch with no device operation, in
the training cells
(``portbench.readers.device_idle``)."""
from portbench.readers import device_idle as read  # noqa: F401
