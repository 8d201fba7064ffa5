"""Matchers layer: the benchmark's spans around ``ImageMatcher.match_pairs``
(the padded device store, LightGlue or SuperGlue, device RANSAC, the h5
writers), in milliseconds over the pairs matched."""


def read(ctx):
    t = ctx.span_s("match_pairs")
    return 1e3 * t / ctx.n_pairs if t > 0 and ctx.n_pairs else None
