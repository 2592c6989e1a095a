"""host_syncs.exact: host-blocking CUDA runtime calls
(``portbench.spans.HOST_SYNCS``) inside the program's ``die.rollout``
spans, a step (``portbench.spans.host_syncs_per_unit`` over the chunk's
steps)."""
from portbench.spans import host_syncs_per_unit


def read(rec):
    per_unit = host_syncs_per_unit(rec, "ROLLOUT")
    if per_unit is None or not rec.model.get("steps"):
        return None
    return per_unit * rec.units / rec.model["steps"]
