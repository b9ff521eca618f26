"""decode.py's block walk and host sync scans: the first core.events
COMPRESSION pair of each decode (host clock), mean per decode."""


def read(window):
    spans = [r.stages["COMPRESSION"][0] for r in window.requests_of("decode")
             if r.stages.get("COMPRESSION")]
    return sum(spans) / len(spans) if spans else None
