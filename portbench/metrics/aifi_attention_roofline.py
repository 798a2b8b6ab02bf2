"""The AIFI attention kernel's share of its bound: the least time the card
could take for each call (bytes, products or exponentials, from the
configuration's shapes) against the device time of the kernels named
``attn_*_kernel``."""

from portbench.core import arith

LAYER = "kernels: ops/attention.py -> csrc/aifi_attention.cu"
UNIT = "%"
MOVES = "frames_per_s.dfine"
KERNELS = r"(?<![A-Za-z0-9_])attn_(bf16|f32)_kernel(?![A-Za-z0-9_])"


def read(rec):
    k = rec.config.get("kernels", {}).get("aifi_attention")
    us, calls = rec.kernel_us(KERNELS)
    if not k or not calls or us <= 0 or not rec.sms:
        return None
    per_call = arith.bound_s(arith.attention_terms(
        rec.traffic["batch"], k["heads"], k["tokens"], k["head_dim"],
        k["dtype"], rec.sms))
    return 100.0 * per_call * calls / (us / 1e6)
