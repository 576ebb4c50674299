"""Device field-op interface: Fp, Fp2 and Fp3 over the limb engine
(PyTorch).

Port of `groth16_tpu/fields/ops.py` (FpOps, Fp2Ops, Fp3Ops).  The
curve/MSM layers are generic over a field-ops object `k` exposing the
lazy-digit op set of fields/fp.py on limb tensors:

  Fp : int32[L, *batch]       (15-bit digits, Montgomery form)
  Fp2: int32[L, 2, *batch]    (c0/c1 stacked on axis 1)
  Fp3: int32[L, 3, *batch]    (c0/c1/c2 stacked on axis 1; MNT6's G2)

`mul_many`/`sub_many` batch independent same-shape ops into one stacked
call, as in the JAX package.  Value contracts: mul inputs < 8p (Fp2:
< 4p), outputs < 2p; add lazy; sub(a, b, k) = a - b + k p.

`plain=True` builds ops whose multiplies run the plain version of K1 on
any device (the plain versions of the point kernels are built on it).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.fp import broadcast_shapes
from groth16_tpu_torch.fields.spec import FpSpec, int_to_limbs


def _bbc(x: torch.Tensor, coord_ndim: int, batch_shape) -> torch.Tensor:
    """Broadcast an element tensor (coords leading) to a full batch shape,
    inserting missing batch axes after the coord axes."""
    cs = tuple(x.shape[:coord_ndim])
    add = len(batch_shape) - (x.dim() - coord_ndim)
    x = x.reshape(cs + (1,) * add + tuple(x.shape[coord_ndim:]))
    return x.expand(cs + tuple(batch_shape))


def _stack_run(op, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], cd: int) -> List:
    """Run `op` once over pairs stacked on a new batch axis at position
    `cd` (just after the coordinate axes)."""
    if len(pairs) == 1:
        return [op(pairs[0][0], pairs[0][1])]
    bshape = broadcast_shapes(
        *[broadcast_shapes(a.shape[cd:], b.shape[cd:]) for a, b in pairs]
    )
    a = torch.stack([_bbc(x, cd, bshape) for x, _ in pairs], dim=cd)
    b = torch.stack([_bbc(y, cd, bshape) for _, y in pairs], dim=cd)
    out = op(a, b)
    return list(out.unbind(dim=cd))


def _stack_map(op, items: Sequence[torch.Tensor], cd: int) -> List:
    if len(items) == 1:
        return [op(items[0])]
    bshape = broadcast_shapes(*[x.shape[cd:] for x in items])
    a = torch.stack([_bbc(x, cd, bshape) for x in items], dim=cd)
    return list(op(a).unbind(dim=cd))


class FpOps:
    """Device ops for the base prime field (G1 coordinates)."""

    tower_deg = 1

    def __init__(self, spec: FpSpec, plain: bool = False):
        self.spec = spec
        self.plain = plain
        self.coord_ndim = 1  # leading dims per element: (L,)

    def coord_shape(self):
        return (self.spec.n_limbs,)

    def zero(self, shape=(), device="cpu"):
        return fp.zeros(self.spec, shape, device=device)

    def one(self, shape=(), device="cpu"):
        return fp.const(self.spec, 1, shape, device=device)

    def const(self, value: int, shape=(), device="cpu"):
        return fp.const(self.spec, value, shape, device=device)

    def add(self, a, b):
        return fp.add(self.spec, a, b)

    def sub(self, a, b, k: int = 2):
        return fp.sub(self.spec, a, b, k=k)

    def sub_exact(self, a, b, k: int = 2):
        return fp.sub_exact(self.spec, a, b, k=k)

    def sub_many(self, pairs, k: int = 2):
        return _stack_run(lambda a, b: fp.sub(self.spec, a, b, k=k), pairs, 1)

    def neg(self, a, k: int = 2):
        return fp.neg(self.spec, a, k=k)

    def reduce2p_many(self, items, bound_k: int = 4):
        """Stacked value reduction to [0, 2p)."""
        return _stack_map(
            lambda x: fp.reduce_to_2p(self.spec, x, bound_k=bound_k), items, 1
        )

    def mul(self, a, b):
        return fp.mont_mul(self.spec, a, b, plain=self.plain)

    def mul_many(self, pairs):
        return _stack_run(self.mul, pairs, 1)

    def is_zero(self, a, bound_k: int = 8):
        return fp.is_zero(self.spec, a, bound_k=bound_k)

    def select(self, mask, a, b):
        """mask ? a : b with mask of batch shape (trailing broadcast)."""
        return torch.where(mask, a, b)

    def inv(self, a):
        return fp.inv(self.spec, a)

    def batch_inv(self, a):
        return fp.batch_inv(self.spec, a)


class Fp2Ops:
    """Device ops for Fq2 = Fq[u]/(u^2 - nonresidue) (G2 coordinates).

    Schoolbook multiplication with the nonresidue folded into a lazy
    post add-chain: c0 = a0*b0 + nr*(a1*b1), c1 = a0*b1 + a1*b0."""

    tower_deg = 2

    def __init__(self, spec: FpSpec, nonresidue: int, plain: bool = False):
        self.spec = spec
        self.plain = plain
        self.nr_int = nonresidue  # signed small int
        self.nonresidue = nonresidue % spec.modulus
        self.coord_ndim = 2  # leading dims per element: (L, 2)
        self._nr_limbs = int_to_limbs(spec.to_mont_int(self.nonresidue), spec.n_limbs)

    def coord_shape(self):
        return (self.spec.n_limbs, 2)

    def _pack(self, c0, c1):
        return torch.stack([c0, c1], dim=1)

    def zero(self, shape=(), device="cpu"):
        return fp.zeros(self.spec, (2,) + tuple(shape), device=device)

    def one(self, shape=(), device="cpu"):
        return self._pack(
            fp.const(self.spec, 1, shape, device=device),
            fp.zeros(self.spec, shape, device=device),
        )

    def const(self, value, shape=(), device="cpu"):
        """value: int (embeds Fp) or (c0, c1) pair."""
        c0, c1 = value if isinstance(value, tuple) else (value, 0)
        return self._pack(
            fp.const(self.spec, c0, shape, device=device),
            fp.const(self.spec, c1, shape, device=device),
        )

    def add(self, a, b):
        return fp.add(self.spec, a, b)

    def sub(self, a, b, k: int = 2):
        return fp.sub(self.spec, a, b, k=k)

    def sub_exact(self, a, b, k: int = 2):
        return fp.sub_exact(self.spec, a, b, k=k)

    def sub_many(self, pairs, k: int = 2):
        return _stack_run(lambda a, b: fp.sub(self.spec, a, b, k=k), pairs, 2)

    def neg(self, a, k: int = 2):
        return fp.neg(self.spec, a, k=k)

    def reduce2p_many(self, items, bound_k: int = 4):
        return _stack_map(
            lambda x: fp.reduce_to_2p(self.spec, x, bound_k=bound_k), items, 2
        )

    def mul_many(self, pairs):
        """Inputs: values < 4p.  Outputs: < 2p, exact digits.  All 4k Fp
        products run as ONE stacked multiply."""
        s = self.spec
        nr = self.nr_int
        fp_pairs = []
        for a, b in pairs:
            a0, a1 = a[:, 0], a[:, 1]
            b0, b1 = b[:, 0], b[:, 1]
            fp_pairs += [(a0, b0), (a1, b1), (a0, b1), (a1, b0)]
        mul = lambda x, y: fp.mont_mul(s, x, y, plain=self.plain)  # noqa: E731
        outs = _stack_run(mul, fp_pairs, 1)
        c0s, c1s = [], []
        for i in range(len(pairs)):
            v00, v11, v01, v10 = outs[4 * i : 4 * i + 4]
            if abs(nr) <= 16:
                t = _fp_mul_small_lazy(v11, abs(nr))  # < 2|nr| p, lazy
                if nr < 0:
                    c0 = (v00, t, 2 * abs(nr))  # defer sub
                else:
                    c0 = (v00 + t, None, 2 + 2 * abs(nr))
            else:
                nr_c = fp._col(self._nr_limbs, v11.device, v11.dim())
                c0 = (fp.add(s, v00, mul(v11, nr_c)), None, 4)
            c0s.append(c0)
            c1s.append(v01 + v10)  # < 4p lazy
        # stacked sub for the negative-nr c0 lanes (one resolving call)
        if c0s and c0s[0][1] is not None:
            k = c0s[0][2]
            c0_vals = _stack_run(
                lambda x, y: fp.sub(s, x, y, k=k), [(x, y) for x, y, _ in c0s], 1
            )
            bound = 2 + k
        else:
            bound = max(kk for _, _, kk in c0s)
            c0_vals = [x for x, _, _ in c0s]
        red0 = _stack_map(
            lambda x: fp.reduce_to_2p(s, x, bound_k=max(4, bound)), c0_vals, 1
        )
        red1 = _stack_map(lambda x: fp.cond_sub(s, x, s.two_p_limbs), c1s, 1)
        return [self._pack(red0[i], red1[i]) for i in range(len(pairs))]

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def is_zero(self, a, bound_k: int = 8):
        # the component axis is just another batch axis to the limb engine
        z = fp.is_zero(self.spec, a, bound_k=bound_k)  # [2, *batch]
        return torch.logical_and(z[0], z[1])

    def select(self, mask, a, b):
        return torch.where(mask, a, b)

    def _norm(self, a):
        """a0^2 - nr*a1^2 (value < 8p, exact digits), the Fq norm that
        inversion divides by."""
        s = self.spec
        a0, a1 = a[:, 0], a[:, 1]
        v0, v1 = _stack_run(lambda x, y: fp.mont_mul(s, x, y, plain=self.plain), [(a0, a0), (a1, a1)], 1)
        nr = self.nr_int
        if abs(nr) <= 16:
            t = _fp_mul_small_lazy(v1, abs(nr))  # < 2|nr| p
            if nr < 0:
                out = v0 + t  # norm = a0^2 + |nr| a1^2, lazy
            else:
                out = fp.sub(s, v0, t, k=2 * nr)
            return fp.reduce_to_2p(s, out, bound_k=2 + 2 * abs(nr))
        w = fp.mont_mul(s, v1, fp._col(self._nr_limbs, v1.device, v1.dim()), plain=self.plain)
        # norm = v0 - nr*v1 with a general (positive-residue) nr constant
        return fp.sub(s, v0, w, k=2)

    def _conj_times(self, a, ninv):
        """(a0, -a1) * ninv: the inverse once ninv = 1 / norm(a)."""
        s = self.spec
        c0, c1m = _stack_run(
            lambda x, y: fp.mont_mul(s, x, y, plain=self.plain),
            [(a[:, 0], ninv), (a[:, 1], ninv)], 1,
        )
        return self._pack(c0, fp.neg(s, c1m, k=2))

    def inv(self, a):
        return self._conj_times(a, fp.inv(self.spec, self._norm(a)))

    def batch_inv(self, a):
        return self._conj_times(a, fp.batch_inv(self.spec, self._norm(a)))


class Fp3Ops:
    """Device ops for Fq3 = Fq[v]/(v^3 - nonresidue) (MNT6 G2
    coordinates).

    Schoolbook multiplication (9 Fp products per Fp3 mul, all in one
    stacked K1 call) with the cubic nonresidue folded into lazy
    add-chains, as in Fp2Ops:
      c0 = v00 + nr*(v12 + v21)
      c1 = v01 + v10 + nr*v22
      c2 = v02 + v11 + v20
    Inversion by the adjugate: a^-1 = (n0 + n1 v + n2 v^2) / N(a) with
      n0 = a0^2 - nr*a1*a2, n1 = nr*a2^2 - a0*a1, n2 = a1^2 - a0*a2,
      N(a) = a0*n0 + nr*(a2*n1 + a1*n2)."""

    tower_deg = 3

    def __init__(self, spec: FpSpec, nonresidue: int, plain: bool = False):
        self.spec = spec
        self.plain = plain
        self.nr_int = nonresidue  # signed small int
        self.nonresidue = nonresidue % spec.modulus
        self.coord_ndim = 2  # leading dims per element: (L, 3)
        self._nr_limbs = int_to_limbs(spec.to_mont_int(self.nonresidue), spec.n_limbs)

    def coord_shape(self):
        return (self.spec.n_limbs, 3)

    def _pack(self, c0, c1, c2):
        return torch.stack([c0, c1, c2], dim=1)

    def zero(self, shape=(), device="cpu"):
        return fp.zeros(self.spec, (3,) + tuple(shape), device=device)

    def one(self, shape=(), device="cpu"):
        z = fp.zeros(self.spec, shape, device=device)
        return self._pack(fp.const(self.spec, 1, shape, device=device), z, z)

    def const(self, value, shape=(), device="cpu"):
        """value: int (embeds Fp) or (c0, c1, c2) triple."""
        c0, c1, c2 = value if isinstance(value, tuple) else (value, 0, 0)
        return self._pack(*(fp.const(self.spec, v, shape, device=device) for v in (c0, c1, c2)))

    def add(self, a, b):
        return fp.add(self.spec, a, b)

    def sub(self, a, b, k: int = 2):
        return fp.sub(self.spec, a, b, k=k)

    def sub_exact(self, a, b, k: int = 2):
        return fp.sub_exact(self.spec, a, b, k=k)

    def sub_many(self, pairs, k: int = 2):
        return _stack_run(lambda a, b: fp.sub(self.spec, a, b, k=k), pairs, 2)

    def neg(self, a, k: int = 2):
        return fp.neg(self.spec, a, k=k)

    def reduce2p_many(self, items, bound_k: int = 4):
        return _stack_map(
            lambda x: fp.reduce_to_2p(self.spec, x, bound_k=bound_k), items, 2
        )

    def _mul(self, x, y):
        return fp.mont_mul(self.spec, x, y, plain=self.plain)

    def _nr_mul(self, v, bound: int):
        """nr * v for v < bound * p -> (lazy value, its bound in p)."""
        nr = self.nr_int
        if abs(nr) <= 16:
            return _fp_mul_small_lazy(v, abs(nr)), bound * abs(nr)
        return self._mul(v, fp._col(self._nr_limbs, v.device, v.dim())), 2

    def mul_many(self, pairs):
        """Inputs: values < 4p.  Outputs: < 2p, exact digits."""
        s = self.spec
        nr = self.nr_int
        fp_pairs = []
        for a, b in pairs:
            a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
            b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
            fp_pairs += [
                (a0, b0), (a1, b2), (a2, b1),  # -> c0
                (a0, b1), (a1, b0), (a2, b2),  # -> c1
                (a0, b2), (a1, b1), (a2, b0),  # -> c2
            ]
        outs = _stack_run(self._mul, fp_pairs, 1)
        comps = ([], [], [])
        for i in range(len(pairs)):
            v00, v12, v21, v01, v10, v22, v02, v11, v20 = outs[9 * i : 9 * i + 9]
            c2 = v02 + v11 + v20  # < 6p lazy
            if abs(nr) <= 16:
                t0 = _fp_mul_small_lazy(v12 + v21, abs(nr))  # < 4|nr| p
                t1 = _fp_mul_small_lazy(v22, abs(nr))  # < 2|nr| p
                if nr < 0:
                    c0 = fp.sub(s, v00, t0, k=4 * abs(nr))
                    c1 = fp.sub(s, v01 + v10, t1, k=2 * abs(nr))
                else:
                    c0 = v00 + t0
                    c1 = v01 + v10 + t1
                k0, k1 = 2 + 4 * abs(nr), 4 + 2 * abs(nr)
            else:
                nr_c = fp._col(self._nr_limbs, v00.device, v00.dim())
                w0, w1 = _stack_run(self._mul, [(v12 + v21, nr_c), (v22, nr_c)], 1)
                c0 = v00 + w0
                c1 = v01 + v10 + w1
                k0, k1 = 4, 6
            for comp, x in zip(comps, (c0, c1, c2)):
                comp.append(x)
        # each component's reductions of every product in one stacked call
        # (the same digits as one call a product)
        red = [
            _stack_map(lambda x, b=bound: fp.reduce_to_2p(s, x, bound_k=b), comp, 1)
            for comp, bound in zip(comps, (max(4, k0), max(4, k1), 6))
        ]
        return [self._pack(*(r[i] for r in red)) for i in range(len(pairs))]

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def is_zero(self, a, bound_k: int = 8):
        z = fp.is_zero(self.spec, a, bound_k=bound_k)  # [3, *batch]
        return torch.logical_and(torch.logical_and(z[0], z[1]), z[2])

    def select(self, mask, a, b):
        return torch.where(mask, a, b)

    def _adjugate(self, a):
        """(n0, n1, n2, norm) per the class docstring; all < 2p exact."""
        s = self.spec
        nr = self.nr_int
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        t0, t1, t2, t3, t4, t5 = _stack_run(
            self._mul, [(a0, a0), (a1, a1), (a2, a2), (a0, a1), (a0, a2), (a1, a2)], 1
        )
        w5, k5 = self._nr_mul(t5, 2)
        w2, k2 = self._nr_mul(t2, 2)
        if abs(nr) <= 16 and nr < 0:
            n0 = fp.reduce_to_2p(s, t0 + w5, bound_k=2 + k5)
            n1 = fp.neg(s, fp.reduce_to_2p(s, w2 + t3, bound_k=2 + k2), k=2)
        else:
            n0 = fp.reduce_to_2p(s, fp.sub(s, t0, w5, k=k5), bound_k=2 + k5)
            n1 = fp.reduce_to_2p(s, fp.sub(s, w2, t3, k=2), bound_k=k2 + 2)
        n2 = fp.reduce_to_2p(s, fp.sub(s, t1, t4, k=2), bound_k=4)
        m0, m1, m2 = _stack_run(self._mul, [(a0, n0), (a2, n1), (a1, n2)], 1)
        wn, kn = self._nr_mul(m1 + m2, 4)
        if abs(nr) <= 16 and nr < 0:
            norm = fp.reduce_to_2p(s, fp.sub(s, m0, wn, k=kn), bound_k=2 + kn)
        else:
            norm = fp.reduce_to_2p(s, m0 + wn, bound_k=2 + kn)
        return n0, n1, n2, norm

    def _times(self, n0, n1, n2, ninv):
        return self._pack(*_stack_run(self._mul, [(n0, ninv), (n1, ninv), (n2, ninv)], 1))

    def inv(self, a):
        n0, n1, n2, norm = self._adjugate(a)
        return self._times(n0, n1, n2, fp.inv(self.spec, norm))

    def batch_inv(self, a):
        n0, n1, n2, norm = self._adjugate(a)
        return self._times(n0, n1, n2, fp.batch_inv(self.spec, norm))


def _fp_mul_small_lazy(a, n: int):
    """a * n (small host int >= 1) via lazy add chain on a raw Fp tensor."""
    assert n >= 1
    acc = None
    base = a
    while n:
        if n & 1:
            acc = base if acc is None else acc + base
        n >>= 1
        if n:
            base = base + base
    return acc
