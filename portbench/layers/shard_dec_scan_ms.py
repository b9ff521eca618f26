"""parallel/tiles.py's block walk and host sync scans in the tile-sharded
decode, one tile after another on the calling thread: the program's span
ako.shard.decode.scan (from the first block read to the last scan), one
a decode, mean ms per decode (the spans ako.shard.decode)."""

from portbench.harness import spans


def read(window):
    found = spans.of(window)
    calls = spans.spans_in(window, "ako.shard.decode", "decode", found)
    inner = spans.spans_in(window, "ako.shard.decode.scan", "decode", found)
    return spans.total_ms(inner) / len(calls) if calls and inner else None
