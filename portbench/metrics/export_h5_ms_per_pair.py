"""IO: the port's ``export.h5_read`` spans in the COLMAP export (each h5
file's open, each group and dataset read), in milliseconds over the
pairs."""


def read(ctx):
    from harness import program

    t = program.spans_s(ctx, "export.h5_read")
    return 1e3 * t / ctx.n_pairs if t and ctx.n_pairs else None
