"""decode.py's pixel download and placement: the core.events FORMAT span
of each decode (host clock), summed over its groups, mean per decode."""


def read(window):
    spans = [sum(r.stages.get("FORMAT", [])) for r in window.requests_of("decode") if r.stages]
    return sum(spans) / len(spans) if spans else None
