"""step_mfu.rollout: the whole stretch's share of the card's peaks, in the
rollout cells
(``portbench.readers.step_mfu``)."""
from portbench.readers import step_mfu as read  # noqa: F401
