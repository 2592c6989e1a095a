"""init_idle_ms.train: device-idle ms a generation inside the program's
``die.init`` spans (``portbench.spans.idle_ms_per_unit``)."""
from portbench.spans import idle_ms_per_unit


def read(rec):
    return idle_ms_per_unit(rec, "INIT")
