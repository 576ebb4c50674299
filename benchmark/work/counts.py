"""Work counts and the published peaks that every roofline divides by.

Frozen copies of the program's counts (groth16_tpu_torch/utils/
profiling.py: mont_mul_word_ops, msm_work_point_adds, ntt_butterflies;
msm/pippenger.py: signed_num_windows; fields/cuda_fp.py: KERNEL_WORDS),
so that a change to the program cannot move the yardstick.  The field
products of one point addition (point_add_word_ops' 13, or 13 x 4 over
Fq2; general_add_products' 14, 52, 114) are the configuration's data.  The window of each MSM is the one
that minimises its own count (`best_window`), not the program's choice.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 132 SMs x 64 INT32 lanes x 1.98 GHz boost,
# one 32-bit multiply-add a lane a clock; HBM3 at 3.35 TB/s.
PEAK_INT32_OPS = 132 * 64 * 1.98e9  # 16.73e12 op/s
PEAK_BYTES = 3.35e12  # B/s

# 32-bit words of one operand of the word engine, by 15-bit digit count L
KERNEL_WORDS = {18: 9, 21: 10, 26: 12, 52: 24}


def limbs(modulus: int) -> int:
    """15-bit digits of an element: the least L with 64 p <= 2^(15 L)."""
    L = -(-modulus.bit_length() // 15)
    while 64 * modulus > 1 << (15 * L):
        L += 1
    return L


def packed_bytes(modulus: int) -> int:
    """Bytes of one element packed in 64-bit words."""
    return 8 * -(-modulus.bit_length() // 64)


def mont_mul_word_ops(n_limbs: int) -> int:
    """32-bit multiplies of one Montgomery product on W-word operands: W
    rows of a_i * b and FULL + 1 reduction rows of m * p (FULL = floor(15 L
    / 32)), each row W products of two multiplies (low and high halves),
    and each reduction row's m."""
    W = KERNEL_WORDS[n_limbs]
    full = 15 * n_limbs // 32
    return 2 * W * W + (full + 1) * (2 * W + 1)


def add_word_ops(n_limbs: int, products: int) -> int:
    """One point addition of `products` base-field products (the
    configuration's count: the a = 0 mixed addition 13 over Fq, 52 over
    Fq2; the generic-a one 14 over Fq, 114 over Fq3)."""
    return products * mont_mul_word_ops(n_limbs)


def signed_num_windows(scalar_bits: int, c: int) -> int:
    W = -(-scalar_bits // c)
    return W + (1 if W * c == scalar_bits else 0)


def msm_work_point_adds(n: int, scalar_bits: int, c: int) -> int:
    """Point additions of one signed-digit Pippenger MSM of n points: n a
    window into buckets, ~2 a bucket to reduce them, and c doublings and
    one addition a window to combine the windows."""
    windows = signed_num_windows(scalar_bits, c)
    buckets = (1 << (c - 1)) + 1
    return windows * (n + 2 * buckets) + windows * (c + 1)


def best_window(n: int, scalar_bits: int) -> int:
    """The window in 1..24 that minimises msm_work_point_adds."""
    return min(range(1, 25), key=lambda c: (msm_work_point_adds(n, scalar_bits, c), c))


def msm_ops(n: int, scalar_bits: int, add_ops: int) -> int:
    """32-bit multiplies one MSM of n points needs at its best window."""
    if n <= 0:
        return 0
    return msm_work_point_adds(n, scalar_bits, best_window(n, scalar_bits)) * add_ops


def ntt_butterflies(n: int) -> int:
    """Butterflies of one radix-2 NTT of size n."""
    return (n // 2) * max(1, (n - 1).bit_length())


def witness_map_ops(domain: int, nnz: int, fr_limbs: int) -> int:
    """32-bit multiplies of the witness map: 7 radix-2 NTTs' butterflies
    (3 inverse, 3 on the coset, 1 back), the A, B and C nonzeros, and 6
    pointwise products an element (the coset shift of A, B and C, A B,
    the division by Z on the coset, the shift back), each a Montgomery
    product of Fr."""
    products = 7 * ntt_butterflies(domain) + nnz + 6 * domain
    return products * mont_mul_word_ops(fr_limbs)


def witness_map_bytes(num_variables: int, nnz: int, domain: int, fr_bytes: int) -> int:
    """The assignment read, the matrices read (a coefficient and a column
    index of 4 bytes a nonzero; the row structure left out) and h written,
    each once."""
    return num_variables * fr_bytes + nnz * (fr_bytes + 4) + domain * fr_bytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES)
