"""init_span_ms.train: host ms a generation inside the program's
``die.init`` spans (``fast_init``), the in-program twin of
``fast_init_ms.train`` (``portbench.spans.host_ms_per_unit``)."""
from portbench.spans import host_ms_per_unit


def read(rec):
    return host_ms_per_unit(rec, "INIT")
