"""parallel/tiles.py's dispatch in the tile-sharded decode: the program's spans
ako.shard.decode.dispatch (one shard's packing of its run of a shape
group, its upload, and the K4 and unlift launches on its stream) that
start in each decode, summed, mean ms per decode (the spans
ako.shard.decode)."""

from portbench.harness import spans


def read(window):
    found = spans.of(window)
    calls = spans.spans_in(window, "ako.shard.decode", "decode", found)
    inner = spans.spans_in(window, "ako.shard.decode.dispatch", "decode", found)
    return spans.total_ms(inner) / len(calls) if calls and inner else None
