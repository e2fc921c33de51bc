"""The fused ZM tail, plain version under the kernel wrapper's name: the
reference never launches a kernel."""

from __future__ import annotations

import torch

from ..models.physics.zm_conv import zm_conv_evap
from ..models.physics.zm_transport import convtran_single, momtran
from ..utils.config import ZMConfig


def zm_tail_ref(cfg: ZMConfig, t1, qv1, pmid, pdel, u, v, q_tr, cld,
                mu, md, du, eu, ed, dp, jt, mx, rprd, prec_in, landfrac,
                ztodt: float):
    """Plain version of `zm_tail`: whole-column PyTorch through the port's
    zm_conv_evap, momtran and convtran_single."""
    ev = zm_conv_evap(cfg, t1, pmid, pdel, qv1, landfrac, rprd, cld, ztodt,
                      prec_in)
    mt = momtran(u, v, mu, md, du, eu, ed, dp, jt, mx, ztodt, cfg.momcu,
                 cfg.momcd)
    ones = torch.ones_like(t1)
    dq = torch.stack([convtran_single(q_tr[:, :, m], ones, mu, md, du, eu,
                                      ed, dp, jt, mx, ztodt)
                      for m in range(q_tr.shape[2])], -1)
    return ev, mt, dq


zm_tail = zm_tail_ref
