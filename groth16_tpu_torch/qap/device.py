"""Device QAP: the prover's witness map (sparse matvec + the 7-NTT
pipeline) and the setup's instance map (PyTorch).

Port of `groth16_tpu/qap/device.py`: the realizations of
`LibsnarkReduction::witness_map_from_matrices` (r1cs_to_qap.rs:172-235)
and `instance_map_with_evaluation` (r1cs_to_qap.rs:128-170), outputs
equal mod p to the exact engine in qap/reduction.py.

Sparse matvec: matrices are COO triples sorted by row.  Per-row sums
come from a segmented inclusive Hillis-Steele scan of `add_strict` over
the row-sorted products, then a gather of each row's last entry.  A
segmented scan stops changing once its step passes the longest row, so
it runs ceil(log2(max row length)) steps.  `add_strict` returns the
unique representative of (a + b) mod 2p in [0, 2p), so the sums carry
the same digits as the JAX package's associative scan in any order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import FpSpec, encode
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.r1cs.matrices import ConstraintMatrices, FlatMatrix
from groth16_tpu_torch.utils import profiling


@dataclasses.dataclass
class DeviceMatrix:
    """One flattened constraint matrix, device-resident.

    coeffs: int32[L, nnz] Montgomery (limb-major); cols: int64[nnz];
    seg_start: bool[nnz] (True at each row's first entry); end_idx:
    int64[num_rows] (index of each row's last entry, 0 for empty rows);
    nonempty: bool[num_rows]; max_row_len: longest row (host int)."""

    coeffs: torch.Tensor
    cols: torch.Tensor
    seg_start: torch.Tensor
    end_idx: torch.Tensor
    nonempty: torch.Tensor
    num_rows: int
    max_row_len: int


def device_matrix_from_numpy(coeffs, cols, seg_start, end_idx, nonempty, num_rows, device) -> DeviceMatrix:
    """Build a DeviceMatrix from host arrays (coeffs: uint32 digits)."""
    starts = np.flatnonzero(np.asarray(seg_start))
    lens = np.diff(np.append(starts, len(seg_start)))
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x).astype(dt)).to(device)  # noqa: E731
    return DeviceMatrix(
        coeffs=t(coeffs, np.int32),
        cols=t(cols, np.int64),
        seg_start=t(seg_start, np.bool_),
        end_idx=t(end_idx, np.int64),
        nonempty=t(nonempty, np.bool_),
        num_rows=int(num_rows),
        max_row_len=int(lens.max()) if len(lens) else 1,
    )


def encode_matrix(m: FlatMatrix, fr: FpSpec, device="cuda") -> DeviceMatrix:
    nnz = m.nnz
    if nnz == 0:
        # one dummy zero entry keeps shapes static and sums exact
        return device_matrix_from_numpy(
            encode([0], fr), np.zeros(1), np.ones(1, bool),
            np.zeros(m.num_rows), np.zeros(m.num_rows, bool), m.num_rows, device,
        )
    row_ptr = np.searchsorted(m.rows, np.arange(m.num_rows + 1))
    nonempty = row_ptr[1:] > row_ptr[:-1]
    end_idx = np.where(nonempty, row_ptr[1:] - 1, 0)
    seg_start = np.zeros(nnz, dtype=bool)
    seg_start[row_ptr[:-1][nonempty]] = True
    return device_matrix_from_numpy(
        encode(m.coeffs, fr), m.cols, seg_start, end_idx, nonempty, m.num_rows, device
    )


def encode_matrices(matrices: ConstraintMatrices, fr: FpSpec, device="cuda"):
    flat = matrices.flatten()
    return {k: encode_matrix(v, fr, device) for k, v in flat.items()}


def sparse_matvec(spec: FpSpec, dm: DeviceMatrix, z: torch.Tensor) -> torch.Tensor:
    """rows_i = <matrix_i, z> mod p -> int32[L, num_rows] Montgomery (< 2p)."""
    with profiling.span("matvec"):
        v = fp.mont_mul(spec, dm.coeffs, z[:, dm.cols])
        f = dm.seg_start
        d = 1
        while d < dm.max_row_len:
            # combine(earlier, current) of the JAX scan: keep current at a
            # segment start, else add the earlier partial sum
            sv = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
            sf = torch.cat([torch.ones_like(f[:d]), f[:-d]])
            v = fp.select(f, v, fp.add_strict(spec, sv, v))
            f = f | sf
            d <<= 1
        sums = v[:, dm.end_idx]
        return fp.select(dm.nonempty, sums, fp.zeros(spec, (dm.num_rows,), device=z.device))


def rows_window(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """x[..., lo:hi], with zero columns (the value 0) past x's end."""
    part = x[..., lo : min(hi, x.shape[-1])]
    return torch.nn.functional.pad(part, (0, hi - lo - part.shape[-1])).contiguous()


def witness_map_device(
    spec: FpSpec,
    ntt,  # NttDomain, or par.ntt_cp.ShardedNtt (its rank's slice)
    mats,  # dict a/b/c -> DeviceMatrix
    z_mont: torch.Tensor,  # int32[L, nv] Montgomery full assignment
    num_inputs: int,
    num_constraints: int,
    window=None,
) -> torch.Tensor:
    """-> h coefficients, int32[L, m] Montgomery (r1cs_to_qap.rs:172-235).

    ntt: the transforms (fft, ifft, coset_fft, coset_ifft of its domain
    of size n).  window: (lo, m), the rows of the zero-padded vectors that
    the transforms take, (0, n) by default; a ShardedNtt takes its rank's
    slice (index * n/S, n/S) and returns that slice of h."""
    lo, m = (0, ntt.size) if window is None else window

    a = sparse_matvec(spec, mats["a"], z_mont)
    b = sparse_matvec(spec, mats["b"], z_mont)
    # input-consistency splice (r1cs_to_qap.rs:195-199): rows
    # [num_constraints, num_constraints + num_inputs) of a get the public
    # inputs; b stays zero there.
    a = rows_window(torch.cat([a[:, :num_constraints], z_mont[:, :num_inputs]], dim=-1), lo, lo + m)
    b = rows_window(b[:, :num_constraints], lo, lo + m)

    a = ntt.coset_fft(ntt.ifft(a))
    b = ntt.coset_fft(ntt.ifft(b))
    ab = fp.mont_mul(spec, a, b)

    c = sparse_matvec(spec, mats["c"], z_mont)
    c = ntt.coset_fft(ntt.ifft(rows_window(c[:, :num_constraints], lo, lo + m)))

    p = spec.modulus
    zg = ntt.evaluate_vanishing_polynomial(ntt.field.generator)
    zg_inv = pow(zg, p - 2, p)
    ab = fp.mont_mul(spec, fp.sub(spec, ab, c), fp.const(spec, zg_inv, (1,), device=z_mont.device))
    return ntt.coset_ifft(ab)


# -- device QAP instance map (setup side) ---------------------------------------


def encode_matrix_transposed(m: FlatMatrix, fr: FpSpec, num_vars: int, device="cuda") -> DeviceMatrix:
    """COLUMN-sorted encoding of a constraint matrix: segments per
    VARIABLE, entries gathering by constraint ROW.  sparse_matvec of it
    with z = the Lagrange-coefficient vector u computes the setup's
    per-variable accumulation a[var] = sum_i u_i(t) * coeff_{i,var}
    (r1cs_to_qap.rs:157-167) with the prover's segmented scan."""
    if m.nnz == 0:
        return device_matrix_from_numpy(
            encode([0], fr), np.zeros(1), np.ones(1, bool),
            np.zeros(num_vars), np.zeros(num_vars, bool), num_vars, device,
        )
    order = np.argsort(m.cols, kind="stable")
    cols_sorted = m.cols[order]
    col_ptr = np.searchsorted(cols_sorted, np.arange(num_vars + 1))
    nonempty = col_ptr[1:] > col_ptr[:-1]
    end_idx = np.where(nonempty, col_ptr[1:] - 1, 0)
    seg_start = np.zeros(m.nnz, dtype=bool)
    seg_start[col_ptr[:-1][nonempty]] = True
    coeffs = encode([m.coeffs[i] for i in order.tolist()], fr)
    return device_matrix_from_numpy(
        coeffs, m.rows[order], seg_start, end_idx, nonempty, num_vars, device
    )


def lagrange_coeffs_device(spec: FpSpec, domain: NttDomain, t: int, xs: torch.Tensor) -> torch.Tensor:
    """All n Lagrange coefficients L_i(t) on the device, Montgomery form.

    The exact engine's O(n) identity (ref/domain.py
    evaluate_all_lagrange_coefficients): on the radix-2 domain H = <w>,
    L_i(t) = (Z(t)/n) * x_i / (t - x_i) with Z(t) = t^n - 1; the
    denominators invert in one batch (fp.batch_inv).  t must lie OUTSIDE
    the domain (generator.rs:90 samples it so).  xs: the domain-element
    table [L, n] (Montgomery), e.g. ntt.powers(spec, domain.group_gen, n)."""
    n = domain.size
    p = spec.modulus
    zt = (pow(t, n, p) - 1) % p
    if zt == 0:
        raise ValueError("t must lie outside the domain")
    c0 = zt * pow(n % p, p - 2, p) % p  # Z(t) / n
    tm = fp.const(spec, t, (1,), device=xs.device)
    invd = fp.batch_inv(spec, fp.sub_strict(spec, tm, xs))
    return fp.mont_mul(spec, fp.mul_const(spec, xs, c0), invd)


def instance_map_device(
    spec: FpSpec,
    domain: NttDomain,
    mats_t,  # dict a/b/c -> transposed DeviceMatrix (encode_matrix_transposed)
    t: int,
    num_instance: int,
    num_constraints: int,
    xs: torch.Tensor,  # see lagrange_coeffs_device
):
    """QAP instance map on the device: per-variable a_i(t), b_i(t), c_i(t)
    (r1cs_to_qap.rs:128-170) as Montgomery [L, num_vars] tensors, equal
    mod p to LibsnarkReduction.instance_map_with_evaluation; the
    input-consistency rows' u_{nc+j}(t) land on the instance variables
    (r1cs_to_qap.rs:150-155)."""
    u = lagrange_coeffs_device(spec, domain, t, xs)
    a = sparse_matvec(spec, mats_t["a"], u)
    b = sparse_matvec(spec, mats_t["b"], u)
    c = sparse_matvec(spec, mats_t["c"], u)
    a_inst = fp.add_strict(spec, a[:, :num_instance], u[:, num_constraints : num_constraints + num_instance])
    return torch.cat([a_inst, a[:, num_instance:]], dim=1), b, c
