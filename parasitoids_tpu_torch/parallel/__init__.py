"""Multi-chain execution of the port (``parasitoids_tpu/parallel``)."""

from .chains import (chain_mesh, init_chains, run_chains,  # noqa: F401
                     shard_chain_states)
