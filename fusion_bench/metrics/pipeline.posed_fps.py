"""Frames a second of the window's untraced frames, from their event
intervals (the posed cell's rate: its frames between cadences are paced
by the host's launches)."""


def read(ctx):
    ms = [m for m, t in zip(ctx["interval_ms"], ctx["traced"]) if not t]
    return 1e3 * len(ms) / sum(ms) if ms and sum(ms) > 0 else None
