"""search_span_ms.train: host ms a generation inside the program's
``die.es.keys``, ``die.es.ask`` and ``die.es.tell`` spans (the key schedule
and the search), the in-program twin of ``es_ms.train``
(``portbench.spans.host_ms_per_unit``)."""
from portbench.spans import host_ms_per_unit


def read(rec):
    return host_ms_per_unit(rec, "ES_KEYS", "ES_ASK", "ES_TELL")
