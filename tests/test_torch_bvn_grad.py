"""Port parity: the closed-form backward of the BVN cell masses
(ops/bvn.py ``_CellMasses``) against ``jax.grad`` of the JAX op (whose
custom JVP is the same closed form), a finite-difference check in f64, and
the shape of the graph it leaves."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_parity import torch

from parasitoids_tpu.ops.bvn import bvn_cell_masses as jax_bvn
from parasitoids_tpu_torch.ops.bvn import bvn_cell_masses, genz_branch

K = 6
THETA = (3.0, -4.0, 21.1, 10.6, 25.0)        # mu_x, mu_y, sig_x, sig_y, cell


def _weights():
    n = 2 * K + 1
    return np.random.default_rng(5).normal(size=(n, n)).astype(np.float32)


@pytest.mark.parametrize('rho', [0.1, 0.5, 0.8, 0.93, -0.93, 0.99])
def test_closed_form_gradient_matches_jax(rho):
    # test_bvn.py's gradient tolerance (rtol 1e-4, atol 1e-8), for every
    # input: mu (2), sig_x, sig_y, rho, cell
    w = _weights()
    theta = np.array([*THETA[:4], rho, THETA[4]], np.float32)

    def jax_obj(t):
        m = jax_bvn(t[0:2], t[2], t[3], t[4], t[5], K)
        return (jnp.asarray(w) * m).sum()

    want = np.asarray(jax.grad(jax_obj)(jnp.asarray(theta)))
    t = torch.tensor(theta, requires_grad=True)
    (torch.from_numpy(w) *
     bvn_cell_masses(t[0:2], t[2], t[3], t[4], t[5], K)).sum().backward()
    got = t.grad.numpy()
    assert np.all(want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize('rho', [0.2, 0.6, 0.85, -0.97])
def test_gradcheck_f64(rho):
    # analytic backward against central differences of the forward, f64,
    # K = 2, one case per node rule and the high-|rho| series
    mu = torch.tensor([3.0, -2.0], dtype=torch.float64, requires_grad=True)
    params = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in (21.0, 15.0, rho, 25.0)]
    assert torch.autograd.gradcheck(
        lambda m, a, b, c, d: bvn_cell_masses(m, a, b, c, d, 2),
        (mu, *params))


def test_graph_keeps_inputs_and_output_not_the_lattice():
    # the backward is the closed-form Function: its graph node keeps the
    # inputs and the clamped output, no per-node quadrature lattice
    mu = torch.zeros((4, 2), requires_grad=True)
    sig = torch.tensor(21.1, requires_grad=True)
    out = bvn_cell_masses(mu, sig, 10.6, 0.5, 25.0, K)
    node = out.grad_fn
    assert type(node).__name__ == '_CellMassesBackward'
    saved = sum(t.numel() for t in node.saved_tensors)
    assert saved == out.numel() + mu.numel() + 4


def test_clamped_sigma_and_rho_pass_no_gradient():
    # the sanitizing clamps' VJPs: zero outside their active range, as in
    # the JAX op (max(sigma, 1e-8), clip(rho, +-(1 - 1e-6)))
    sig = torch.tensor(-3.0, requires_grad=True)
    rho = torch.tensor(1.5, requires_grad=True)
    bvn_cell_masses(torch.zeros(2), sig, 10.6, rho, 25.0, 2).sum().backward()
    assert float(sig.grad) == 0.0 and float(rho.grad) == 0.0


@pytest.mark.parametrize('rho', [0.1, 0.5, 0.8, 0.93, -0.99])
def test_given_branch_gives_the_bits_of_a_read_rho(rho):
    # a caller that read |rho| once passes its Genz branch; the cell masses
    # are those of a rho read inside the op, and the argument takes effect
    mu = torch.tensor([3.0, -4.0])
    r = torch.tensor(rho)
    want = bvn_cell_masses(mu, 21.1, 10.6, r, 25.0, K)
    branch = genz_branch(abs(rho))
    assert torch.equal(bvn_cell_masses(mu, 21.1, 10.6, r, 25.0, K, branch),
                       want)
    other = bvn_cell_masses(mu, 21.1, 10.6, r, 25.0, K, 3 - (branch == 3))
    assert not torch.equal(other, want)
