"""Kernel dispatch: the launches of the hand-written kernels in the window
(the sum of ``ops/_lib.LAUNCHES``, counted by the program) over the pairs."""


def read(ctx):
    return ctx.launches / ctx.n_pairs if ctx.launches and ctx.n_pairs else None
