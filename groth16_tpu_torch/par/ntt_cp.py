"""Sharded NTT: four-step (Bailey) decomposition over a mesh axis.

Port of `groth16_tpu/par/ntt_cp.py` (SURVEY.md §2.4 "ntt_cp", §5.7): the
length-n coefficient vector is sharded across ranks; local butterfly
stages run on each rank's card (K1 for every product) and the only
communication is three all-to-all block transposes.

Math (n = n1*n2, w the order-n root, input a[j], j = j1*n2 + j2):
  X[k2*n1 + k1] = sum_{j2} w2^{j2 k2} * w^{j2 k1} * A1[k1, j2]
  A1[k1, j2]    = sum_{j1} w1^{j1 k1} * a[j1*n2 + j2]
with w1 = w^{n2} (order n1), w2 = w^{n1} (order n2).  Steps on each rank:
  1. view [n1, n2] sharded by rows; transpose (all_to_all) -> [n2, n1]
  2. local length-n1 NTTs along the last axis (batched _ntt_core)
  3. twiddle by w^{j2*k1} (this rank's rows, built by _geometric_rows)
  4. transpose back -> [n1, n2]; local length-n2 NTTs
  5. transpose -> natural-order output sharded by k2 rows
Coset offsets and 1/n are local elementwise passes with this rank's
slice of the power tables.  Output order and values match NttDomain
(equal mod p).

A rank builds only its own slices of the tables (base^(i0 + j) =
base^i0 * base^j, j < n/S): no table of length n is held whole on one
card.  They are cached per (field, base, rank, device), as NttDomain
caches its tables.  Radix-2 domains only, as in the JAX package.
"""

from __future__ import annotations

import functools

import torch

from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import FpSpec
from groth16_tpu_torch.ntt.ntt import NttDomain, _ntt_core, _stage_tws, powers
from groth16_tpu_torch.par.collectives import transpose_a2a
from groth16_tpu_torch.par.mesh import DATA_AXIS, axis_size


def _geometric_rows(spec: FpSpec, row_bases: torch.Tensor, n_cols: int) -> torch.Tensor:
    """rows[.., i, k] = row_bases[.., i]^k for k < n_cols (Montgomery, on
    the device).  row_bases: [L, rows] -> [L, rows, n_cols].

    Log-doubling along the column axis: log2(n_cols) wide multiplies."""
    if n_cols & (n_cols - 1):
        raise ValueError(f"_geometric_rows: {n_cols} columns is not a power of two")
    cur = fp.const(spec, 1, tuple(row_bases.shape[1:]) + (1,), device=row_bases.device)  # [L, rows, 1]
    scale = row_bases[..., None]  # base^(2^t) per row
    length = 1
    while length < n_cols:
        nxt = fp.mont_mul(spec, cur, scale)
        cur = torch.cat([cur, nxt], dim=-1)
        scale = fp.mont_mul(spec, scale, scale)
        length *= 2
    return cur


@functools.lru_cache(maxsize=None)
def _power_slice(spec: FpSpec, base: int, start: int, m: int, const: int, device: torch.device) -> torch.Tensor:
    """const * base^(start + j) for j < m, Montgomery [L, m]."""
    p = spec.modulus
    head = fp.const(spec, const * pow(base, start, p) % p, (1,), device=device)
    return fp.mont_mul(spec, powers(spec, base, m, device), head)


@functools.lru_cache(maxsize=None)
def _twiddles(spec: FpSpec, gen: int, n1: int, n2: int, S: int, index: int, device: torch.device) -> torch.Tensor:
    """w^(j2 k1) for this rank's rows j2 = index (n2/S) + [0, n2/S) and
    every k1 < n1: [L, n2/S, n1]."""
    rows = n2 // S
    return _geometric_rows(spec, _power_slice(spec, gen, index * rows, rows, 1, device), n1)


class ShardedNtt:
    """Four-step (i)NTT over `mesh` for one (field, n) domain.

    Data layout: int32[L, n/S] Montgomery (limb-major), this rank's
    contiguous slice of the element axis.  n must satisfy n = n1 * n2
    with S | n1 and S | n2 (S = mesh axis size); the split is
    n1 = 2^ceil(log/2).  `size`, `field` and
    `evaluate_vanishing_polynomial` are the domain's, as on NttDomain
    (qap/device.witness_map_device takes either)."""

    def __init__(self, domain: NttDomain, mesh, axis=DATA_AXIS):
        if domain.radixes:
            raise ValueError(f"ShardedNtt: radix-2 domains only, not {domain.size} (radixes {domain.radixes})")
        self.domain = domain
        self.size, self.field = domain.size, domain.field
        self.evaluate_vanishing_polynomial = domain.evaluate_vanishing_polynomial
        self.mesh = mesh
        self.axis = axis
        self.ax = mesh.axis(axis)
        self.spec = domain.spec
        n = domain.size
        S = axis_size(mesh, axis)
        n1 = 1 << ((domain.log_size + 1) // 2)
        n2 = n // n1
        if n1 % S or n2 % S:
            raise ValueError(f"ShardedNtt: n={n} too small for a mesh of {S} ranks")
        self.n1, self.n2, self.S = n1, n2, S

    def _apply(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        spec = self.spec
        n1, n2, S = self.n1, self.n2, self.S
        L = spec.n_limbs
        p = self.domain.field.modulus
        dev = a.device
        if tuple(a.shape) != (L, n1 * n2 // S):
            raise ValueError(f"ShardedNtt: a rank's slice is [{L}, {n1 * n2 // S}], got {list(a.shape)}")
        gen = self.domain.group_gen_inv if inverse else self.domain.group_gen
        x = a.reshape(L, n1 // S, n2)
        x = transpose_a2a(x, self.ax)  # [L, n2/S, n1]
        x = _ntt_core(spec, x, _stage_tws(spec, pow(gen, n2, p), n1, dev))  # length-n1 NTTs
        # twiddle w^{j2*k1}: row j2 (global), col k1
        x = fp.mont_mul(spec, x, _twiddles(spec, gen, n1, n2, S, self.ax.index, dev))
        x = transpose_a2a(x, self.ax)  # [L, n1/S, n2]
        x = _ntt_core(spec, x, _stage_tws(spec, pow(gen, n1, p), n2, dev))  # length-n2 NTTs
        x = transpose_a2a(x, self.ax)  # [L, n2/S, n1] = output rows k2
        return x.reshape(L, n1 * n2 // S)

    def _scale(self, a: torch.Tensor, base: int, const: int = 1) -> torch.Tensor:
        """a[j] *= const * base^j on this rank's slice of j."""
        m = self.domain.size // self.S
        if base == 1:
            return fp.mul_const(self.spec, a, const)
        table = _power_slice(self.spec, base, self.ax.index * m, m, const, a.device)
        return fp.mont_mul(self.spec, a, table)

    def fft(self, coeffs: torch.Tensor, offset: int = 1) -> torch.Tensor:
        a = coeffs
        if offset != 1:
            a = self._scale(a, offset)
        return self._apply(a, inverse=False)

    def ifft(self, evals: torch.Tensor, offset: int = 1) -> torch.Tensor:
        a = self._apply(evals, inverse=True)
        p = self.domain.field.modulus
        if offset != 1:
            return self._scale(a, pow(offset, p - 2, p), self.domain.size_inv)
        return self._scale(a, 1, self.domain.size_inv)

    def coset_fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self.fft(coeffs, offset=self.domain.field.generator)

    def coset_ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self.ifft(evals, offset=self.domain.field.generator)
