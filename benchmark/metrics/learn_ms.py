"""Host clock around each ``ppo.learn`` call of the window until its
metrics are on the host; the mean per iteration."""


def read(ctx):
    spans = ctx.spans.get("learn_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
