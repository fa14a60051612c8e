"""The roofline counts against hand counts at K = 6: minutes whose
take-off probability is 0 are left out, and each parameter set takes
Genz's tier for its own |rho|, whatever node rule a launch uses."""

import math

import pytest
import torch

from bench_torch import roofline

K, CELL, L = 6, 25.0, 81 + 4 * 6
M = 2 * K + 2                       # corners on a side: 14


def minutes():
    h = torch.tensor([0.0, 0.2, 0.0, 0.1, 0.3, 0.0, 0.05, 0.1, 0.0, 0.4])
    mu = torch.zeros(10, 2)
    return h, mu                    # 6 of 10 minutes active


@pytest.mark.parametrize('rho,nodes', [(0.1, 6), (-0.5, 12), (0.8, 20)])
def test_forward_counts_active_minutes_at_their_tier(rho, nodes):
    h, mu = minutes()
    exps, fp, nbytes = roofline.forward_work(h, mu, (150.0, 140.0, rho),
                                             CELL, K, L)
    corners = 6 * M * M
    assert exps == corners * nodes + 2 * M * 6
    assert fp == corners * nodes * 2
    assert nbytes == 4 * 10 + 6 * (8 + 8 + 4) + 4 * L * L


def test_backward_adds_the_adjoint_of_each_corner():
    h, mu = minutes()
    exps, fp, nbytes = roofline.backward_work(h, mu, (150.0, 140.0, 0.1),
                                              CELL, K, L)
    corners = 6 * M * M
    assert exps == corners * 6 + 2 * M * 6 + 3 * corners + 2 * M * 6
    assert fp == corners * 6 * 2 + 2 * corners
    assert nbytes == 4 * 10 + 6 * 20 + 4 * L * L + 16 * 6


def test_batched_takes_each_particles_own_tier():
    """The select rule's launch runs 20 nodes to |rho| 0.925; the count is
    6 + 12 + 20 nodes for these three particles."""
    h, mu = minutes()
    hs, mus = h.expand(3, -1), mu.expand(3, -1, -1)
    dps = [(150.0, 140.0, 0.1), (150.0, 140.0, 0.5), (150.0, 140.0, -0.8)]
    exps, _, _ = roofline.batched_work(hs, mus, dps, CELL, K, L)
    corners = 6 * M * M
    assert exps == corners * (6 + 12 + 20) + 3 * 2 * M * 6


def test_high_rho_counts_the_series_terms_that_pass_their_cutoffs():
    """|rho| >= 0.925: at most the leading term, the product term (2),
    20 tail nodes (2 each) and the final Phi (1 or 2) a corner; far
    corners drop terms."""
    h, mu = minutes()
    exps, _, _ = roofline.forward_work(h, mu, (150.0, 140.0, 0.95), CELL, K,
                                       L)
    corners = 6 * M * M
    assert 3 * corners < exps - 2 * M * 6 <= (1 + 2 + 40 + 1) * corners


def test_least_seconds_prices_exps_at_the_combined_rate():
    assert math.isclose(roofline.EXP_RATE, 33.5e12 * (1 / 8 + 1 / 4))
    sec, what = roofline.least_seconds(roofline.EXP_RATE, 0, 0)
    assert (sec, what) == (1.0, 'exps')
    sec, what = roofline.least_seconds(0, 0, 3.35e12)
    assert (sec, what) == (1.0, 'bytes')
