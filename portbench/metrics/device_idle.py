"""The device: the share of the window in which the card ran nothing, from
the union of its activity intervals in the trace (copies beside kernels
count once), averaged over the cards, in percent."""


def read(ctx):
    if not ctx.busy_s:
        return None
    busy = sum(ctx.busy_s.values()) / ctx.n_cards
    return 100.0 * (1.0 - busy / ctx.window_s) if busy > 0 else None
