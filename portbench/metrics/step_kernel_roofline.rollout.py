"""step_kernel_roofline.rollout: the step kernel's share of its roofline,
in the rollout cells
(``portbench.readers.step_kernel_roofline``)."""
from portbench.readers import step_kernel_roofline as read  # noqa: F401
