"""step_idle_ms.exact: device-idle ms a step inside the program's
``die.rollout`` spans (``portbench.spans.idle_ms_per_unit`` over the
chunk's steps)."""
from portbench.spans import idle_ms_per_unit


def read(rec):
    per_unit = idle_ms_per_unit(rec, "ROLLOUT")
    if per_unit is None or not rec.model.get("steps"):
        return None
    return per_unit * rec.units / rec.model["steps"]
