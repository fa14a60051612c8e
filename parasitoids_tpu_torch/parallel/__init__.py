"""Multi-chain and multi-device execution of the port
(``parasitoids_tpu/parallel``): the device mesh, chains sharded over it
(``chains``), ensembles (``ensemble``) and the minute-sharded forward
(``domain``)."""

from .chains import (Mesh, chain_mesh, init_chains, run_chains,  # noqa: F401
                     shard_chain_states)
