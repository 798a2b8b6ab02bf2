"""The NMS sweep kernels' share of their bound: of each candidate row kept
at its step, the IoUs after it, plus the valid and keep vectors, as the
reference's own sweep over the checked frames needs them, against the
device time of the ``mask_kernel`` and ``sweep_kernel`` launches (one
sweep a call)."""

from portbench.core import arith

LAYER = "kernels: ops/suppress.py -> csrc/nms_suppress.cu"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = r"(?<![A-Za-z0-9_])(mask|sweep)_kernel(_wide)?(?![A-Za-z0-9_])"
CALLS = r"(?<![A-Za-z0-9_])sweep_kernel(_wide)?(?![A-Za-z0-9_])"


def read(rec):
    k = rec.config.get("kernels", {}).get("nms_suppress")
    tail = rec.ref_stats.get("nms_alive_tail_per_frame")
    us, _ = rec.kernel_us(KERNELS)
    _, calls = rec.kernel_us(CALLS)
    if not k or tail is None or not calls or us <= 0:
        return None
    B = rec.traffic["batch"]
    per_call = arith.bound_s(arith.nms_suppress_terms(
        B, k["candidates"], round(tail * B)))
    return 100.0 * per_call * calls / (us / 1e6)
