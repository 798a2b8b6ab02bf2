"""The work each hand-written kernel of the served paths needs, from its
shapes and from the data the reference computes on the same frames.

Frozen copies of the arithmetic of the port's ``chip_smoke.py`` kernel
records (kernels 1, 2, 4 and 5 of PERF.md's table): every input byte read
once and every output byte written once, and where the work depends on the
data, what these inputs need. A bound is the larger of bytes over the HBM
peak and operations over the precision's peak, in seconds.
"""

from __future__ import annotations

from typing import Dict

from portbench.core.peaks import (MAX_SM_CLOCK_HZ, PEAK_BYTES_PER_S,
                                  PEAK_FLOP_PER_S, SFU_EXP_PER_CLK_PER_SM)

ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_terms(B: int, heads: int, N: int, dh: int, dtype: str,
                    sms: int) -> Dict[str, float]:
    """AIFI attention over (B, heads, N, dh): q, k, v read and o written;
    4·B·heads·N²·dh FLOP of products; B·heads·N² exponentials on the SFUs.
    bf16 products count at the bf16 peak, f32-accurate ones at the faster
    of the f32 CUDA cores and three TF32 products each."""
    e = ELEMENT_BYTES[dtype]
    nbytes = 4 * B * N * heads * dh * e
    flops = 4 * B * heads * N * N * dh
    exps = B * heads * N * N
    if dtype == "float32":
        ops = min(flops / PEAK_FLOP_PER_S["float32"],
                  3 * flops / PEAK_FLOP_PER_S["tf32"])
    else:
        ops = flops / PEAK_FLOP_PER_S[dtype]
    return {"bytes": nbytes / PEAK_BYTES_PER_S, "operations": ops,
            "exp": exps / (SFU_EXP_PER_CLK_PER_SM * sms * MAX_SM_CLOCK_HZ)}


def onehot_gather_terms(B: int, T: int, C: int, distinct_rows: int,
                        dtype: str) -> Dict[str, float]:
    """One-hot row gather of T taps a frame from (B, L, C) tables: the
    output and the int32 indices, and each distinct row read once."""
    e = ELEMENT_BYTES[dtype]
    nbytes = B * T * C * e + B * T * 4 + distinct_rows * C * e
    return {"bytes": nbytes / PEAK_BYTES_PER_S}


def nms_suppress_terms(B: int, K: int, alive_tail: int
                       ) -> Dict[str, float]:
    """The greedy sweep over (B, K, K) IoUs: of each row i kept at its step,
    the part j > i (``alive_tail`` = the sum of K - 1 - i over kept rows),
    f32; valid read and keep written."""
    nbytes = 4 * alive_tail + 2 * 4 * B * K
    return {"bytes": nbytes / PEAK_BYTES_PER_S}


def assemble_masks_terms(B: int, K: int, Hp: int, Wp: int, P: int,
                         inside_pixels: int) -> Dict[str, float]:
    """sigmoid(coeffs · protos) cropped to K boxes: protos, coeffs and boxes
    read and the (B, K, Hp, Wp) f32 masks written; 2·P FLOP for each pixel
    inside a box."""
    nbytes = 4 * (B * Hp * Wp * P + B * K * P + B * K * 4 + B * K * Hp * Wp)
    flops = 2 * P * inside_pixels
    return {"bytes": nbytes / PEAK_BYTES_PER_S,
            "operations": flops / PEAK_FLOP_PER_S["float32"]}


def bound_s(terms: Dict[str, float]) -> float:
    return max(terms.values())
