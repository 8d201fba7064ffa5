"""Matchers: LightGlue's layers run a pair, the port's ``lightglue.layers``
counter (layers run times the chunk's real pairs, after each chunk's layer
loop) over the pairs: the model's depth at full depth, fewer once the
depth exit fires."""


def read(ctx):
    from harness import program

    n = [r.value for r in program.named(ctx, "lightglue.layers")]
    return sum(n) / ctx.n_pairs if n and ctx.n_pairs else None
