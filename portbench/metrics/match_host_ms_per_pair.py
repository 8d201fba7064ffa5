"""Matchers: the host's own time in the port's ``match`` spans, each less
the union of its ``sync.*`` and ``wait.*`` spans on the same thread, in
milliseconds over the pairs."""


def read(ctx):
    from harness import program
    from harness.trace import union_ns

    recs = program.records(ctx)
    if not recs or not ctx.n_pairs:
        return None
    blocked = {}
    for r in recs:
        if r.name.startswith(("sync.", "wait.")) and r.parent and \
                (r.parent == "match" or r.parent.startswith("match/")):
            blocked.setdefault(r.run, []).append((r.start_ns, r.end_ns))
    total = 0
    matches = [r for r in recs if r.name == "match"]
    for m in matches:
        inside = [(max(a, m.start_ns), min(b, m.end_ns)) for a, b in blocked.get(m.run, [])
                  if b > m.start_ns and a < m.end_ns]
        total += (m.end_ns - m.start_ns) - sum(b - a for a, b in union_ns(inside))
    return total / 1e6 / ctx.n_pairs if matches else None
