"""The cards' idle share over the window's tile-sharded encodes and
decodes: the time in the profiler's ranges portbench.encode and
portbench.decode in which no kernel or copy ran on any of the cards,
over their wall time, in percent. The profiler's device events carry no
card here (trace.Window keeps none), so busy is their union over the
four cards: a card idle while another works counts as busy."""


def read(window):
    spans = window.ranges.get("portbench.encode", []) + window.ranges.get("portbench.decode", [])
    wall = sum(b - a for a, b in spans)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(window.busy_in(a, b) for a, b in spans) / wall)
