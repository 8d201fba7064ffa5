"""IO layer: the benchmark's spans around ``io.h5_to_db.export_to_colmap``
(the COLMAP database written from the h5 files), in milliseconds over the
pairs."""


def read(ctx):
    t = ctx.span_s("export_to_colmap")
    return 1e3 * t / ctx.n_pairs if t > 0 and ctx.n_pairs else None
