"""Entry: the port's ``setup`` (configuration, extractor and matcher with
their checkpoints) and ``pairs`` (pair generation) spans, in milliseconds a
job of the window."""


def read(ctx):
    from harness import program

    t = program.spans_s(ctx, "setup", "pairs")
    return 1e3 * t / program.n_jobs(ctx) if t and program.n_jobs(ctx) else None
