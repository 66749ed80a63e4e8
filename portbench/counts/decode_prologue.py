"""The least time of the decode prologue kernel (``csrc/prologue.cu``):
a frozen copy of ``chip_smoke.py:prologue_bound_ms``."""

from .peaks import F32_OPS_PER_S, HBM_BYTES_PER_S


def prologue_bound_ms(T, N, Vp1, m, itemsize, bias_bytes=0):
    """The logits (and the bias, once) in, top-M values and indices and
    three stats out; six operations a lane, one more with a bias."""
    rows = T * N
    bytes_ = rows * Vp1 * itemsize + bias_bytes + rows * (2 * m * 4 + 3 * 4)
    # max, subtract, exp, add, key, compare per lane; the bias's add
    ops = rows * Vp1 * 6 + (rows * (Vp1 - 1) if bias_bytes else 0)
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3, (
        "bytes" if bytes_ / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    )


def bound_ms_true_lengths(frames, Vp1, m, itemsize):
    """The bound for the frames the inputs need: ``frames`` the sum of the
    utterances' true lengths (rows past a length are padding)."""
    return prologue_bound_ms(int(frames), 1, Vp1, m, itemsize)[0]
