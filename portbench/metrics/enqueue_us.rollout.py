"""enqueue_us.rollout: the median host us of one of the program's
``die.step`` spans in the stretch, a step's host enqueue at the rollout
entry (``portbench.spans.median_us``)."""
from portbench.spans import median_us


def read(rec):
    return median_us(rec, "STEP")
