"""Kernels: kernel 1's share of its roofline in the window
(``portbench/kernels/attention.py``), in percent."""


def read(ctx):
    return ctx.roofline("attention")
