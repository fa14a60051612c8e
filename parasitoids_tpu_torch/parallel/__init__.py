"""Multi-chain and multi-device execution of the port
(``parasitoids_tpu/parallel``): the device mesh and chains sharded over
it (``chains``), and ensembles (``ensemble``).  The JAX package's
minute-sharded forward (``domain``) has no port: one forward runs on one
device."""

from .chains import (Mesh, chain_mesh, init_chains, run_chains,  # noqa: F401
                     shard_chain_states)
