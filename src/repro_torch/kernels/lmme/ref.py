"""Plain PyTorch version of the LMME kernel, at the kernel's calling
convention: the paper's compromise LMME from ``core.ops``, so the kernel is
held to the same function the rest of the port uses; and the exact eq. 9
(``lmme_naive``, O(ndm) memory) as the oracle for small shapes."""

from ...core.goom import Goom
from ...core.ops import lmme_naive, lmme_reference


def lmme_ref(a_log, a_sign, b_log, b_sign):
    """(out_log, out_sign) of ``lmme_reference`` on plane tensors."""
    out = lmme_reference(Goom(a_log, a_sign), Goom(b_log, b_sign))
    return out.log_abs, out.sign


def lmme_ref_exact(a_log, a_sign, b_log, b_sign):
    """(out_log, out_sign) of the exact ``lmme_naive`` on plane tensors."""
    out = lmme_naive(Goom(a_log, a_sign), Goom(b_log, b_sign))
    return out.log_abs, out.sign
