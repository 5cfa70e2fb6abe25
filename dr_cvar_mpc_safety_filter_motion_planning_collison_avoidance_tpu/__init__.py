"""DR-CVaR safety-filtering engine for motion planning (JAX, GPU).

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
implementation of "Distributionally Robust CVaR-Based Safety Filtering for
Motion Planning in Uncertain Environments" (arXiv:2309.08821).

Design (see SURVEY.md section 7):
  * every component is a pytree-in / pytree-out jittable pure function;
  * the CVaR / DR-CVaR halfspace convex programs (reference
    core/risk_metrics.py:84-265, solved there with CVXPY+ECOS) are replaced
    with exact closed-form batched reductions (top-k tail mean);
  * the MPC safety-filter QP (reference core/mpc_filter.py:40-178, solved
    there with CVXPY+OSQP) is replaced by a condensed, batched primal-dual
    interior-point solver that vmaps over thousands of instances;
  * serial loops over (timestep x obstacle x metric x run) become array axes
    sharded over a `jax.sharding.Mesh`.

Import as:

    import dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu as dct
"""

from . import config
from . import core
from . import ops
from . import models
from . import simulation
from . import evaluation
from . import parallel
from . import utils

__version__ = "0.1.0"
