"""The device's idle share over the window's encode calls: the time in the
profiler's ranges portbench.encode in which no kernel or copy ran on the
card, over their wall time, in percent."""


def read(window):
    return window.idle_share("encode")
