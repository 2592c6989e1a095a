"""step_kernel_roofline.train: the step kernel's share of its roofline, in
the training cells
(``portbench.readers.step_kernel_roofline``)."""
from portbench.readers import step_kernel_roofline as read  # noqa: F401
