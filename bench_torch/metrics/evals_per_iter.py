"""Value+gradient evaluations an optimizer iteration: the window's
``map_fit.EVALS`` over its Adam steps and L-BFGS iterations
(``map_fit.ADAM_STEPS`` + ``map_fit.LBFGS_ITERS``); None where the
program has no such counters."""


def read(ctx, runner, name):
    c = ctx.window['counters']
    if not {'map_evals', 'adam_steps', 'lbfgs_iters'} <= set(c):
        return None
    iters = c['adam_steps'] + c['lbfgs_iters']
    return c['map_evals'] / iters if iters else None
