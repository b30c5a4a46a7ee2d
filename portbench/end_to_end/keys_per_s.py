"""Keys sorted per second: every key of every call in the window over
the window's seconds (first issue to last return)."""


def read(w) -> float:
    return w.calls * w.keys_per_card * w.world / max(w.window_s)
