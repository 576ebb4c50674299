"""Radix-2 and mixed-radix (coset) NTT over the limb engine (PyTorch).

Port of `groth16_tpu/ntt/ntt.py:NttDomain`: the `ark-poly`
Radix2EvaluationDomain behavior the witness map consumes — forward/
inverse NTT on the subgroup H = <w> of size n, coset domains g*H via
pre/post scaling, natural-order outputs [f(g*w^0), f(g*w^1), ...] and 1/n
normalization — and, where the field's 2-adicity is too small (MNT6-298's
Fr: 17), the MixedRadixEvaluationDomain fallback to the smallest
2^a 3^b 5^c 7^d size (`_ntt_core_mixed`).

Each DIF stage views the trailing element axis as [blocks, m] and
butterflies the contiguous halves: lower = u + v, upper = (u - v) * tw
with the stage's twiddles broadcast across blocks — one K1 multiply
(fields/cuda_fp.py) plus plain tensor ops per stage; a gather applies
the bit reversal at the end.  Twiddle and offset power tables are built
on the device by log-doubling and cached per (field, base, n, device).
The mixed-radix core peels the odd radixes first as generalised DIF
stages (K1 products against columns of the root's power table), then runs
the radix-2 core on the power-of-two tail with the blocks as a batch
axis, and one gather restores natural order.  Like the JAX package's, it
has no kernel of its own: its products are K1's.
"""

from __future__ import annotations

import functools
import math

import torch

from groth16_tpu_torch.config import resolve_device
from groth16_tpu_torch.curves.params import FieldParams
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import FpSpec, encode, make_spec
from groth16_tpu_torch.ref.domain import _element_of_order, _smooth_sizes
from groth16_tpu_torch.utils import profiling


def _enc(values, spec: FpSpec, device) -> torch.Tensor:
    return torch.from_numpy(encode(list(values), spec).astype("int32")).to(device)


def powers_device(spec: FpSpec, base: int, n: int, device) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] in Montgomery form, built on the device
    by log-doubling: p_{2k} = p_k * base^k; log2(n) wide multiplies."""
    assert n & (n - 1) == 0, "power-of-two table"
    p = spec.modulus
    cur = _enc([1], spec, device)  # [L, 1]
    length = 1
    b_pow = base % p
    while length < n:
        nxt = fp.mont_mul(spec, cur, _enc([b_pow], spec, device))
        cur = torch.cat([cur, nxt], dim=-1)
        b_pow = b_pow * b_pow % p
        length *= 2
    return cur


@functools.lru_cache(maxsize=None)
def powers(spec: FpSpec, base: int, n: int, device: torch.device) -> torch.Tensor:
    """Cached device-resident power table (any n >= 1)."""
    n2 = 1 << (n - 1).bit_length()
    return powers_device(spec, base, n2, device)[:, :n].contiguous()


@functools.lru_cache(maxsize=None)
def _bitrev_perm(n: int, device: torch.device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.to(device)


@functools.lru_cache(maxsize=None)
def _stage_tws(spec: FpSpec, base: int, n: int, device: torch.device):
    """Per-DIF-stage twiddles: stage s (block m = n >> s, half h = m/2)
    multiplies its upper half by root^((q - h) 2^s), q - h in [0, h) —
    every 2^s-th power of the table."""
    rp = powers(spec, base, n, device)
    return tuple(
        rp[:, :: 1 << s][:, : n >> (s + 1)].contiguous()
        for s in range(n.bit_length() - 1)
    )


def _ntt_core(spec: FpSpec, a: torch.Tensor, tws) -> torch.Tensor:
    """Radix-2 DIF NTT along the trailing element axis; natural order in
    and out.  a: int32[L, ..., n]; tws: _stage_tws of the root (pass the
    inverse root's tables for the inverse transform)."""
    n = a.shape[-1]
    log_n = n.bit_length() - 1
    if log_n == 0:
        return a
    lead = tuple(a.shape[:-1])
    nb = len(lead) - 1  # middle batch dims between limb and element axes
    for s in range(log_n):
        m = n >> s
        h = m >> 1
        x = a.reshape(lead + (n // m, m))
        u = x[..., :h]
        v = x[..., h:]
        tw = tws[s].reshape(tws[s].shape[:1] + (1,) * (nb + 1) + (h,))
        sum_ = fp.cond_sub(spec, u + v, spec.two_p_limbs)
        diff = fp.mont_mul(spec, fp.sub(spec, u, v, k=2), tw)
        a = torch.cat([sum_, diff], dim=-1).reshape(lead + (n,))
    return a.index_select(-1, _bitrev_perm(n, a.device))


def _odd_radixes(n: int):
    """Odd prime radix sequence of n (largest first) and the power-of-two
    tail M: n = prod(radixes) * M."""
    radixes = []
    m = n
    for q in (7, 5, 3):
        while m % q == 0:
            radixes.append(q)
            m //= q
    assert m & (m - 1) == 0, f"non-smooth NTT size {n}"
    return tuple(radixes), m


@functools.lru_cache(maxsize=None)
def _mixed_storage_perm(n: int, radixes, M: int, device: torch.device) -> torch.Tensor:
    """Final gather composing the odd-stage DIF digit placement with the
    natural-order radix-2 block transforms: out[k] = storage[perm[k]]
    where k = r0 + q0*(r1 + q1*(... + k_sub)) lands at storage
    sum_i r_i * (n / prod_{j<=i} q_j) + k_sub."""
    rem = torch.arange(n, dtype=torch.int64)
    base = torch.zeros(n, dtype=torch.int64)
    div = n
    for q in radixes:
        base += (rem % q) * (div // q)
        rem = rem // q
        div //= q
    return (base + rem).to(device)


def _ntt_core_mixed(spec: FpSpec, a: torch.Tensor, root_powers: torch.Tensor, radixes, sub_tws) -> torch.Tensor:
    """Mixed-radix DIF NTT along the trailing element axis; natural order
    in and out (the JAX package's `_ntt_core_mixed`).  The odd prime
    factors (7/5/3) are peeled first as generalised DIF stages over
    contiguous slices — radix-q butterfly y_r = (sum_j W_q^{jr} u_j) *
    w_m^{r t} with W_q's entries columns of the n-entry power table and the
    stage twiddles strided slices of it — leaving n/M independent radix-2
    transforms of the power-of-two tail M (_ntt_core, the blocks a batch
    axis; sub_tws: its stage twiddles for root^(n/M)).

    Ledger: stage inputs < 2p exact; y_r pre-twiddle < 2q p lazy (< R at
    every L with a kernel); the twiddle product's output < 2p; r = 0
    lanes are value-reduced back to < 2p."""
    n = a.shape[-1]
    lead = tuple(a.shape[:-1])
    ones = (1,) * len(lead)
    m = n
    for q in radixes:
        h = m // q
        B = n // m
        x = a.reshape(lead + (B, q, h))
        us = [x[..., j, :] for j in range(q)]
        ys = []
        for r in range(q):
            acc = us[0]
            for j in range(1, q):
                col = (n // q) * j * r % n
                w = root_powers[:, col : col + 1].reshape((-1,) + ones + (1,))
                acc = acc + fp.mont_mul(spec, us[j], w)
            if r == 0:
                y = fp.reduce_to_2p(spec, acc, bound_k=2 * q)
            else:
                tw = root_powers[:, :: (n // m) * r][:, :h]
                y = fp.mont_mul(spec, acc, tw.reshape((-1,) + ones[1:] + (1, h)))
            ys.append(y)
        a = torch.stack(ys, dim=-2).reshape(lead + (n,))
        m = h
    M = m
    a = _ntt_core(spec, a.reshape(lead + (n // M, M)), sub_tws).reshape(lead + (n,))
    if not radixes:
        return a
    return a.index_select(-1, _mixed_storage_perm(n, radixes, M, a.device))


class NttDomain:
    """Evaluation domain of size n over field `field`, with its device
    tables on `device`: radix-2 where the field's 2-adicity allows, else
    the smallest 2^a 3^b 5^c 7^d smooth size (the MNT6 regime; mirrors
    groth16_tpu.ntt.ntt.NttDomain and ref/domain.py's rounding)."""

    def __init__(self, field: FieldParams, num_coeffs: int, device="cuda"):
        n = 1
        log_n = 0
        while n < num_coeffs:
            n <<= 1
            log_n += 1
        self.field = field
        self.device = resolve_device(device)
        self.spec = make_spec(field.modulus, name=field.name)
        p = field.modulus
        if log_n <= field.two_adicity:
            self.size = n
            self.log_size = log_n
            self.group_gen = pow(field.two_adic_root_of_unity, 1 << (field.two_adicity - log_n), p)
            self.radixes = ()
        else:
            cands = [m for m in _smooth_sizes(p - 1, field.two_adicity) if m >= num_coeffs]
            if not cands:
                raise ValueError("PolynomialDegreeTooLarge")
            self.size = cands[0]
            self.log_size = self.size.bit_length() - 1  # informational only
            self.group_gen = _element_of_order(p, self.size)
            self.radixes, _ = _odd_radixes(self.size)
        self.group_gen_inv = pow(self.group_gen, p - 2, p)
        self.size_inv = pow(self.size, p - 2, p)

    def _offset_powers(self, offset: int) -> torch.Tensor:
        return powers(self.spec, offset, self.size, self.device)

    def _core(self, a: torch.Tensor, fwd: bool) -> torch.Tensor:
        base = self.group_gen if fwd else self.group_gen_inv
        if not self.radixes:
            return _ntt_core(self.spec, a, _stage_tws(self.spec, base, self.size, self.device))
        odd = math.prod(self.radixes)
        p = self.field.modulus
        sub_tws = _stage_tws(self.spec, pow(base, odd, p), self.size // odd, self.device)
        return _ntt_core_mixed(
            self.spec, a, powers(self.spec, base, self.size, self.device), self.radixes, sub_tws
        )

    def fft(self, coeffs: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """coefficients -> evaluations on offset*H.  coeffs: int32[L, n]
        Montgomery form; shorter inputs must be pre-padded by the caller."""
        a = coeffs
        assert a.shape[-1] == self.size
        with profiling.span("ntt"):
            if offset != 1:
                a = fp.mont_mul(self.spec, a, self._offset_powers(offset))
            return self._core(a, fwd=True)

    def ifft(self, evals: torch.Tensor, offset: int = 1) -> torch.Tensor:
        spec = self.spec
        with profiling.span("ntt"):
            a = self._core(evals, fwd=False)
            a = fp.mont_mul(spec, a, fp.const(spec, self.size_inv, (1,), device=a.device))
            if offset != 1:
                p = self.field.modulus
                a = fp.mont_mul(spec, a, self._offset_powers(pow(offset, p - 2, p)))
            return a

    def coset_fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluations on GENERATOR*H (r1cs_to_qap.rs:204-207)."""
        return self.fft(coeffs, offset=self.field.generator)

    def coset_ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self.ifft(evals, offset=self.field.generator)

    def evaluate_vanishing_polynomial(self, t: int, offset: int = 1) -> int:
        p = self.field.modulus
        return (pow(t, self.size, p) - pow(offset, self.size, p)) % p
