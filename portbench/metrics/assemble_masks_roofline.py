"""The mask decode kernel's share of its bound: protos, coefficients and
boxes read, the f32 masks written, and the products for the pixels inside
the reference's boxes of the checked frames, against the device time of
the ``masks_kernel`` launches."""

from portbench.core import arith

LAYER = "kernels: ops/masks.py -> csrc/assemble_masks.cu"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = r"(?<![A-Za-z0-9_])masks_kernel(?![A-Za-z0-9_])"


def read(rec):
    k = rec.config.get("kernels", {}).get("assemble_masks")
    inside = rec.ref_stats.get("mask_inside_pixels_per_frame")
    us, calls = rec.kernel_us(KERNELS)
    if not k or inside is None or not calls or us <= 0:
        return None
    B = rec.traffic["batch"]
    per_call = arith.bound_s(arith.assemble_masks_terms(
        B, k["slots"], k["proto_side"], k["proto_side"], k["protos"],
        round(inside * B)))
    return 100.0 * per_call * calls / (us / 1e6)
