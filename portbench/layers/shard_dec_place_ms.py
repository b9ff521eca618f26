"""parallel/tiles.py's placement in the tile-sharded decode: the program's spans
ako.shard.decode.place (one shard's wait for its stream, the pixels'
download and their placement in the image, a run) that start in each
decode, summed, mean ms per decode (the spans ako.shard.decode)."""

from portbench.harness import spans


def read(window):
    found = spans.of(window)
    calls = spans.spans_in(window, "ako.shard.decode", "decode", found)
    inner = spans.spans_in(window, "ako.shard.decode.place", "decode", found)
    return spans.total_ms(inner) / len(calls) if calls and inner else None
