"""host_syncs.train: host-blocking CUDA runtime calls
(``portbench.spans.HOST_SYNCS``) inside the program's ``die.generation``
spans, a generation (``portbench.spans.host_syncs_per_unit``)."""
from portbench.spans import host_syncs_per_unit


def read(rec):
    return host_syncs_per_unit(rec, "GENERATION")
