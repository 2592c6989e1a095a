"""step_mfu.train: the whole stretch's share of the card's peaks, in the
training cells
(``portbench.readers.step_mfu``)."""
from portbench.readers import step_mfu as read  # noqa: F401
