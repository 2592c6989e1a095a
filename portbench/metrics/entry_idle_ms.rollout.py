"""entry_idle_ms.rollout: device-idle ms a chunk inside the program's
``die.rollout`` spans (``portbench.spans.idle_ms_per_unit``)."""
from portbench.spans import idle_ms_per_unit


def read(rec):
    return idle_ms_per_unit(rec, "ROLLOUT")
