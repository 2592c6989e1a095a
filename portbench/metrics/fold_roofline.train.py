"""fold_roofline.train: the reward fold's share of its roofline, in the
training cells
(``portbench.readers.fold_roofline``)."""
from portbench.readers import fold_roofline as read  # noqa: F401
