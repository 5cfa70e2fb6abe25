from . import halfspace
from . import qp_ipm
from .halfspace import (Halfspace, mean_halfspace, cvar_halfspace,
                        dr_cvar_halfspace, cvar_g_star, dr_cvar_g_star,
                        kth_largest_radix_select)
from .qp_ipm import QPSolution, solve_qp, solve_qp_batched
from . import qp_ipm_structured
from .qp_ipm_structured import MPCQPSolution, solve_mpc_qp
from . import pallas_kernels
from .pallas_kernels import fused_metric_halfspaces
from . import native_qp
