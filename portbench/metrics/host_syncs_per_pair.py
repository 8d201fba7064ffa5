"""Kernel dispatch: the port's ``sync.*`` spans on the job's thread inside
``match``, each one blocking device-to-host point (an exit flag, a
result, an upload, a solver's error check), over the pairs. The feature
writer's ``sync.download`` waits on its own thread and stalls no dispatch:
it is not counted. Meaningful on CUDA only: on the CPU the same points are
counted, though none of them waits for a device."""


def read(ctx):
    from harness import program

    recs = program.records(ctx)
    if not recs or not ctx.n_pairs:
        return None
    return sum(1 for r in recs if r.name.startswith("sync.") and r.parent
               and program.path(r).split("/")[0] == "match") / ctx.n_pairs
