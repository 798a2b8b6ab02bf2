"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Shares of a peak
are stated against these, with the card's power limit printed beside
them."""

PEAK_FLOP_PER_S = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,       # outside the tensor cores
    "float8": 1979e12,
    "int8": 1979e12,
}
PEAK_BYTES_PER_S = 3.35e12  # HBM3
# the SFUs' exponentials, 16 a clock on each SM, at the SXM part's highest
# SM clock; the AIFI attention's bound counts its exponentials there
SFU_EXP_PER_CLK_PER_SM = 16
MAX_SM_CLOCK_HZ = 1.98e9
