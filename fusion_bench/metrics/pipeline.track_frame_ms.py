"""Mean interval (ms) of the window's frames that neither integrate nor mesh
(the traced frames left out: the profiler slows them)."""


def read(ctx):
    ms = [m for f, m, t in zip(ctx["frame_ids"], ctx["interval_ms"], ctx["traced"])
          if f % ctx["cadence"] != 0 and not t]
    return sum(ms) / len(ms) if ms else None
