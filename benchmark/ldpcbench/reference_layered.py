"""The plain reference of the layered schedule: torch and NumPy only,
written from the definition, imported from nothing of the program under
test.

It keeps the arithmetic contract of the program's layered decoders (the
plain one and the CUDA kernels, bit for bit for min-sum and
sumproduct-fast):

* block-rows in ascending order; the Z checks of block-row i together,
  each reading the posterior P as the block-rows before it left it;
* for edge e = (i, j, s) of the row and check r: q = P[j*Z + (r+s) % Z] -
  R[e, r], that is roll(P_col, -s) - R_e;
* the check-node update of ``reference.py`` on the row's q (min-sum:
  first-occurrence two-min scan, out = (sign product * own sign) *
  (alpha * exclusive minimum); sumproduct-fast: three-smallest scan and
  the power-of-two piecewise linear soft-min);
* P_col = roll(q + r_new, +s), from the unrounded r_new; R_e = r_new
  (rounded to bfloat16 first with ``msg_bf16``, the lower-precision
  control);
* the syndrome before the first iteration (iters_used 0) and after each
  one; a converged frame keeps its posterior from then on.

``LayeredDecoder`` is called as ``reference.Decoder`` is, so
``reference.MonteCarlo`` takes it unchanged.  Its call runs with TF32
off (the encoder's float64 product does not use it either way).
"""

from __future__ import annotations

import torch

from ldpcbench.reference import Decoder, _check_update


class LayeredDecoder(Decoder):
    """Layered BP of `code`: llr (F, n) float32 -> (bits uint8 (F, n), ok
    bool (F,), iters_used int32 (F,))."""

    def _iteration(self, L, P, R, tab):
        c = self.code
        F = P.shape[0]
        P = P.clone()
        R = R.clone().view(F, c.E, c.Z)
        var_of = tab["var_of"].view(c.E, c.Z)
        e0 = 0
        for i in range(c.mb):
            e1 = e0 + int(c.row_deg[i])  # row i's edges, in column order
            idx = var_of[e0:e1]  # (deg, Z): distinct variables
            q = P[:, idx] - R[:, e0:e1]
            out = _check_update(q[:, None], tab["row_deg"][i:i + 1],
                                self.algo, self.alpha)[:, 0]
            P[:, idx] = q + out
            if self.msg_bf16:
                out = out.to(torch.bfloat16).to(torch.float32)
            R[:, e0:e1] = out
            e0 = e1
        return P, R.view(F, c.E * c.Z)

    def __call__(self, llr: torch.Tensor):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return super().__call__(llr)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
