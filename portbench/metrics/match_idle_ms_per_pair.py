"""The device: the cards' idle time inside the port's ``match`` spans (the
gaps between the union of each card's activity intervals), averaged over
the cards, in milliseconds over the pairs; the card's runs only."""


def read(ctx):
    from harness import program
    from harness.trace import clip, gaps, union_ns

    matches = program.named(ctx, "match")
    if ctx.trace is None or not ctx.trace.events or not matches or not ctx.n_pairs:
        return None
    idle = 0
    for d in range(ctx.n_cards):
        busy = union_ns([(a, b) for dev, _, a, b in ctx.trace.events if dev == d])
        for m in matches:
            idle += sum(b - a for a, b in gaps(clip(busy, m.start_ns, m.end_ns),
                                               m.start_ns, m.end_ns))
    return idle / ctx.n_cards / 1e6 / ctx.n_pairs
