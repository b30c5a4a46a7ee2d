"""Keys sorted per second across the cards: every key of every rank's
calls in the window over the slowest rank's window (the ranks start the
window together and make the same calls)."""


def read(w) -> float:
    return w.calls * w.keys_per_card * w.world / max(w.window_s)
