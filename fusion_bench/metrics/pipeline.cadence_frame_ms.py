"""Mean interval (ms) of the window's integrate-and-mesh frames (the traced
frames left out)."""


def read(ctx):
    ms = [m for f, m, t in zip(ctx["frame_ids"], ctx["interval_ms"], ctx["traced"])
          if f % ctx["cadence"] == 0 and not t]
    return sum(ms) / len(ms) if ms else None
