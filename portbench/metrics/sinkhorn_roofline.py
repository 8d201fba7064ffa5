"""Kernels: kernel 7's share of its roofline in the window
(``portbench/kernels/sinkhorn.py``), in percent; SuperGlue's cells only."""


def read(ctx):
    return ctx.roofline("sinkhorn")
