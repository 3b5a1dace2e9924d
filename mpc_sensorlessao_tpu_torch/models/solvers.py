"""MPC solver backends, the real-time subset (port of
``mpc_sensorlessao_tpu/models/solvers.py``):

* ``closed_form``  -- U = closed_form_matrix @ r (one matmul, README.md:417);
* ``fastmpc``      -- the structured fixed Newton-KKT step (ops.newton_kkt),
                      built here by ``make_fastmpc_problem``.

ADMM, the dense stacked oracle and geninv are not ported yet
(ROADMAP.md A.8).
"""

from __future__ import annotations

import torch

from ..ops import newton_kkt
from .mpc import MPCMatrices


def closed_form(mats: MPCMatrices, r: torch.Tensor) -> torch.Tensor:
    """Unconstrained minimizer of U'HU + r'U; batched over leading dims."""
    return r @ mats.closed_form.T


def make_fastmpc_problem(A1, A2, B, q_weight, p_weight, r_weight, u_max,
                         barrier_k, du_max=0.0,
                         u_prev=None) -> newton_kkt.FastMPCProblem:
    """FastMPCProblem from reference-style scalar weights (README.md:344-356:
    Q=q*I, P=p*I, R=r*I, symmetric box), in the dtype and on the device
    of ``B``."""
    n, m = B.shape
    kw = dict(dtype=B.dtype, device=B.device)

    def full(v, size):
        return torch.full((size,), float(v), **kw)

    return newton_kkt.FastMPCProblem(
        A1=A1.to(**kw), A2=A2.to(**kw), B=B,
        q_diag=full(q_weight, n), qf_diag=full(p_weight, n),
        r_diag=full(r_weight, m),
        u_min=full(-u_max, m), u_max=full(u_max, m),
        barrier_k=torch.tensor(float(barrier_k), **kw),
        du_min=full(-du_max, m), du_max=full(du_max, m),
        u_prev=full(0.0, m) if u_prev is None else u_prev.to(**kw),
    )
