"""Plain reference of parallel tempering's swap round: the even–odd
pairing of a ladder's rungs and the exchange rule, in plain torch.

A ladder ``1 = beta_0 > beta_1 > ... > beta_{T-1}`` holds one replica a
rung.  A round of parity ``p`` pairs the neighbours ``(i, i + 1)`` for
``i = p, p + 2, p + 4, ...`` while ``i + 1 < T``; every other rung sits
the round out.  A pair exchanges its states when ``log u < log alpha``,
with ``u`` the round's uniform of the pair (one a neighbouring pair,
indexed by the left rung ``i``) and

    log alpha = (beta_i - beta_j) * (loglik_j - loglik_i),  j = i + 1,

``loglik`` the untempered log likelihood of each rung's state before the
swap.  Written from that equation, in float64; nothing here imports the
program.
"""

from __future__ import annotations

import torch


def pairs(T, parity):
    """The left rungs of the pairs a round of ``parity`` attempts."""
    return list(range(int(parity), T - 1, 2))


def log_alpha(betas, ll, i):
    """The exchange's log acceptance of the pair ``(i, i + 1)``
    (float64 tensors ``betas`` and ``ll`` of one a rung)."""
    return (betas[i] - betas[i + 1]) * (ll[i + 1] - ll[i])


def sweep(betas, ll, parity, u):
    """One round's decisions: ``(perm, accepts, attempts, margins)``.
    ``perm[t]``: the rung whose state rung ``t`` holds after the round;
    ``accepts`` and ``attempts``: one a neighbouring pair (indexed by its
    left rung), 1 or 0; ``margins``: ``{i: |log u_i - log alpha_i|}`` for
    the attempted pairs, the distance of each decision from its
    threshold.  ``betas``, ``ll``, ``u``: sequences of numbers (``u`` one a
    neighbouring pair)."""
    f64 = torch.float64
    betas = torch.as_tensor(betas, dtype=f64)
    ll = torch.as_tensor(ll, dtype=f64)
    u = torch.as_tensor(u, dtype=f64)
    T = betas.shape[0]
    perm = list(range(T))
    accepts = [0] * max(T - 1, 0)
    attempts = [0] * max(T - 1, 0)
    margins = {}
    for i in pairs(T, parity):
        la = log_alpha(betas, ll, i)
        log_u = torch.log(u[i])
        attempts[i] = 1
        if bool(log_u < la):
            accepts[i] = 1
            perm[i], perm[i + 1] = i + 1, i
        margins[i] = float((log_u - la).abs())
    return perm, accepts, attempts, margins
