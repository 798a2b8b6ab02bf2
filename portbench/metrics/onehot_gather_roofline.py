"""The one-hot row gather kernel's share of its bound: the output, the
indices and the distinct rows that the reference's own gathers read on the
checked frames (a frame and a call), against the device time of the
``onehot_tile`` kernels."""

from portbench.core import arith

LAYER = "kernels: ops/gather.py -> csrc/onehot_gather.cu"
UNIT = "%"
MOVES = "frames_per_s.dfine"
KERNELS = r"(?<![A-Za-z0-9_])onehot_tile(?![A-Za-z0-9_])"


def read(rec):
    k = rec.config.get("kernels", {}).get("onehot_gather")
    rows = rec.ref_stats.get("onehot_rows_per_frame_call")
    us, calls = rec.kernel_us(KERNELS)
    if not k or not rows or not calls or us <= 0:
        return None
    B = rec.traffic["batch"]
    per_call = arith.bound_s(arith.onehot_gather_terms(
        B, k["taps"], k["channels"], round(rows * B), k["dtype"]))
    return 100.0 * per_call * calls / (us / 1e6)
