"""env_steps_per_s: every env-step of the window over its seconds, the
chunk in flight at the close included."""


def read(rec):
    return rec.work / rec.elapsed_s if rec.elapsed_s > 0 else None
