"""tpulbm — a D2Q9-BGK Lattice-Boltzmann framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
MPI/C solver (d2q9-bgk.c in ag14774/MPILattice-Boltzmann):

- SoA ``(9, ny, nx)`` float32 state instead of AoS structs (d2q9-bgk.c:95-98);
  the contiguous dimension is ``nx``.
- A pure ``step(state) -> state`` function under ``jax.lax.scan`` replaces the
  in-place double-buffer pointer swap (d2q9-bgk.c:376-378); XLA buffer donation
  provides the same zero-copy reuse.
- Distribution is ``jax.shard_map`` over a 1-D device mesh with width-1 halo
  rows moved by ``jax.lax.ppermute`` (ring), replacing persistent MPI requests
  (d2q9-bgk.c:295-313,326-366). The periodic y-boundary falls out of the ring
  wrap-around exactly as in the reference's neighbour arithmetic
  (d2q9-bgk.c:245-247).
- The hot loop is one plain ``jax.numpy`` step that XLA fuses: pull-stream +
  inflow acceleration + BGK collision + bounce-back + on-device |u|
  reduction, equivalent to the reference's fused ``timestep``
  (d2q9-bgk.c:493-704) and ``accelerate_flow`` (d2q9-bgk.c:442-478).
- The per-step average-velocity series is accumulated locally and reduced with
  a single deferred ``psum``, mirroring the reference's single post-loop
  ``MPI_Reduce`` (d2q9-bgk.c:367-374,396).
"""

__version__ = "0.1.0"

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.sim.simulation import Simulation

__all__ = ["LBMParams", "initial_state", "Simulation", "__version__"]
