"""Matchers: RANSAC's stream time, the port's ``ransac`` device spans (CUDA
events on the stream around ``ransac_fundamental_store_batch``, recorded
while the profiler runs), in milliseconds over the pairs; the card's runs
only. The time between the two events holds the card's idle gaps as well
as RANSAC's kernels: the waits for the host's launches after RANSAC's own
solver syncs (``sync.eigh``, ``sync.svd``) count here, so fewer syncs move
it as much as faster kernels do."""


def read(ctx):
    from harness import program

    ms = [r.value for r in program.named(ctx, "ransac") if r.value is not None]
    return sum(ms) / ctx.n_pairs if ms and ctx.n_pairs else None
