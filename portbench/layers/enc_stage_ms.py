"""encode.py's staging and upload: the core.events FORMAT span of each
encode (host clock), summed over its shape groups, mean per encode."""


def read(window):
    spans = [sum(r.stages.get("FORMAT", [])) for r in window.requests_of("encode") if r.stages]
    return sum(spans) / len(spans) if spans else None
