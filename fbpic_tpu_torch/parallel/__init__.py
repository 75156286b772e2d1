"""z-domain decomposition over a mesh of slabs (fbpic_tpu's parallel/).

One process, one thread per slab (``group``), the slabs meeting only in
the guard exchange, the particle migration and the counters' sums:
``distribute_simulation(sim, devices=[...])`` then ``run.step(N)``,
which goes through the slabs' chunk runner (``SlabMultiStep``: every
step replayed from one CUDA graph a card, the cross-card exchanges
inside).
"""
from .mesh import Mesh, make_mesh, particle_dp_shardings
from .group import SlabGroup, SlabComm, card_groups
from .domain import (
    MIGRATION_FIELDS, local_grid_config, exchange_guards_replace,
    exchange_guards_add, migrate_particles, make_multichip_step, local_aux,
    build_multichip_state, Halo, SlabMultiStep, sum_guards,
)
from .api import DistributedRun, distribute_simulation

__all__ = [
    "DistributedRun", "Halo", "MIGRATION_FIELDS", "Mesh",
    "SlabComm", "SlabGroup", "SlabMultiStep", "build_multichip_state",
    "card_groups", "distribute_simulation", "exchange_guards_add",
    "exchange_guards_replace", "local_aux", "local_grid_config",
    "make_mesh", "make_multichip_step", "migrate_particles",
    "particle_dp_shardings", "sum_guards",
]
