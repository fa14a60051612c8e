"""parasitoids_tpu_torch — PyTorch/CUDA port of the dispersal model and
its Bayesian layer.

The JAX package ``parasitoids_tpu`` is the reference; this package runs the
same forward simulation (wind -> per-day dispersal kernels -> FFT
propagation over days), the MAP fit and the adaptive-Metropolis sampler
with PyTorch, and replaces the JAX package's fused
Pallas day-accumulate with a CUDA kernel written for Hopper
(``csrc/day_kernel.cu``).  It imports ``torch`` and never ``jax``, and
nothing of the JAX package: it keeps its own copies of the host-only
modules it needs (``config``, ``io/``, ``utils/checks``,
``utils/durable``, ``bayes/diagnostics``, ``viz/plot_result``,
``viz/bayes_plot``).  Its entry points run on the card unless the caller
asks for the CPU (``device='cpu'``, ``--device cpu``).

Layout mirrors the JAX package:
  config.py        run parameters (``Params``)
  device.py        device and dtype policy
  io/              wind, field data (``LocInfo``), site specs, saved runs
  ops/             flight probabilities, BVN cell masses, daily kernel,
                   the CUDA day-accumulate and its build
  models/          FFT propagation, the end-to-end forward model, the
                   observation projections
  bayes/           priors, transforms, the log posterior, the MAP fit,
                   the adaptive-Metropolis sampler, its trace store and
                   command line (``python -m parasitoids_tpu_torch.bayes.run``)
  parallel/        the device mesh; chains, starts, replicas, particles
                   and draws sharded over it; the minute-sharded forward
  utils/           numerical sanitizers of a run's fields; durable commits
  viz/             per-day plots of a run (``--plot``); MCMC diagnostics
  cli.py           ``python -m parasitoids_tpu_torch [flags] [key=value ...]``
"""

__version__ = "0.1.0"
