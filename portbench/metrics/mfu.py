"""The whole job: the model FLOPs of the window's jobs, each part at the
published peak of its precision (``portbench/flops/<config>.py``), over the
window's time and the cards, in percent."""


def read(ctx):
    if not ctx.model_least_s:
        return None
    return 100.0 * ctx.model_least_s / (ctx.window_s * ctx.n_cards)
