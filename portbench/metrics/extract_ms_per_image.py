"""Extractors layer: the benchmark's spans around
``ImageMatcher.extract_features`` (SuperPoint through the prefetch pool and
the device handoff), in milliseconds over the images extracted."""


def read(ctx):
    t = ctx.span_s("extract_features")
    return 1e3 * t / ctx.n_images if t > 0 and ctx.n_images else None
