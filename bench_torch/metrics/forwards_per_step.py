"""The share of a ladder's proposals that ran the forward: the window's
``sampler.FORWARDS`` over its units, one a replica proposal (a proposal
outside the prior's support skips the forward)."""


def read(ctx, runner, name):
    w = ctx.window
    if not w['units'] or 'forwards' not in w['counters']:
        return None
    return w['counters']['forwards'] / w['units']
