"""The device's idle share over the stream's window: the time in the
profiler's range portbench.stream in which no kernel or copy ran on the
card, over its wall time, in percent."""


def read(window):
    return window.idle_share("stream")
