"""encode.py's size and row download and the framing: the core.events
COMPRESSION span of each encode (host clock), mean per encode."""


def read(window):
    spans = [sum(r.stages.get("COMPRESSION", [])) for r in window.requests_of("encode")
             if r.stages]
    return sum(spans) / len(spans) if spans else None
