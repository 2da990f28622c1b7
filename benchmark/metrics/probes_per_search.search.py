"""Probes a search ran (``FerSearchResult.probes``), averaged over the
searches of the traced window: the search layer's work per answer."""


def read(view):
    r = view.readings
    if not r.get("searches"):
        return None
    return r["probes"] / r["searches"]
