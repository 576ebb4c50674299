"""arkworks-compatible canonical (de)serialization.

Re-implements the `ark-serialize` wire format consumed by the reference's
`#[derive(CanonicalSerialize, CanonicalDeserialize)]` on Proof /
VerifyingKey / PreparedVerifyingKey / ProvingKey
(arkworks-rs/groth16 src/data_structures.rs:8,31,87,125), so our artifacts are
byte-identical with arkworks' and interchangeable with it
(SURVEY.md §2.2 "Serialization" row):

- Fp: little-endian canonical integer, ceil(modulus_bits / 8) bytes.
- Flagged Fp (curve points): 2 SW flag bits live in the top bits of the
  final byte (fits because every supported modulus has bits % 8 <= 6):
  bit7 = y-is-negative (y > p - y), bit6 = point-at-infinity.
- Fp2: c0 then c1; flags go on the last byte of c1.
- G1/G2 affine compressed: x with flags.  Uncompressed: x plain, then y
  with flags.  Infinity: zero coordinates + infinity flag.
- Vec<T>: u64 little-endian length prefix, then elements.
- Struct: fields in declaration order.
"""

from __future__ import annotations

import io
from typing import List, Tuple

from groth16_tpu_torch.curves.params import CurveParams, get_curve
from groth16_tpu_torch.protocol.data_structures import Proof, ProvingKey, VerifyingKey
from groth16_tpu_torch.ref import field as F

FLAG_INFINITY = 1 << 6
FLAG_Y_NEG = 1 << 7


class SerializationError(ValueError):
    pass


def _nbytes(p: int) -> int:
    return (p.bit_length() + 7) // 8


# -- field elements -----------------------------------------------------------


def _ser_fp(v: int, p: int, flags: int = 0) -> bytes:
    n = _nbytes(p)
    if p.bit_length() % 8 > 6 and flags:
        raise SerializationError("no room for flags")
    buf = bytearray((v % p).to_bytes(n, "little"))
    buf[-1] |= flags
    return bytes(buf)


def _de_fp(data: bytes, p: int, with_flags: bool) -> Tuple[int, int]:
    buf = bytearray(data)
    flags = 0
    if with_flags:
        flags = buf[-1] & 0xC0
        buf[-1] &= 0x3F
    v = int.from_bytes(bytes(buf), "little")
    if v >= p:
        raise SerializationError("field element out of range")
    return v, flags


def _is_neg(y: int, p: int) -> bool:
    """arkworks SWFlags::from_y_coordinate: negative iff y > -y."""
    return y > p - y


# -- points -------------------------------------------------------------------


def ser_g1(pt, c: CurveParams, compress: bool = True) -> bytes:
    p = c.p
    if pt is None:
        x, y, flags = 0, 0, FLAG_INFINITY
    else:
        x, y = pt
        flags = FLAG_Y_NEG if _is_neg(y, p) else 0
    if compress:
        return _ser_fp(x, p, flags)
    return _ser_fp(x, p) + _ser_fp(y, p, flags)


def de_g1(r: io.BytesIO, c: CurveParams, compress: bool = True, validate: bool = True):
    p = c.p
    n = _nbytes(p)
    if compress:
        x, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        rhs = (x * x % p * x + c.a * x + c.b) % p
        y = F.sqrt_fp(rhs, p)
        if y is None:
            raise SerializationError("x not on curve")
        neg = (p - y) % p
        y_big, y_small = max(y, neg), min(y, neg)
        y = y_big if flags & FLAG_Y_NEG else y_small
    else:
        x, _ = _de_fp(r.read(n), p, False)
        y, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
    pt = (x, y)
    if validate:
        from groth16_tpu_torch.ref import curve as rc

        A = c.a % p if c.a else 0
        if not rc.is_on_curve_fp(p, c.b, pt, A=A):
            raise SerializationError("point not on curve")
        # subgroup check (ark-serialize Validate::Yes): the native
        # engine's scalar multiplication where it loads, else Python's
        from groth16_tpu_torch.native import native_pairing

        nat = native_pairing(c.name)
        if nat is not None:
            if nat.g1_subgroup_check([pt]):
                raise SerializationError("point not in subgroup")
        elif rc.mul_fp(p, pt, c.r, A=A) is not None:
            raise SerializationError("point not in subgroup")
    return pt


def _ser_fp_point(pt, p: int, compress: bool) -> bytes:
    """Serialize an affine point with Fq coordinates (G1, or bw6 G2)."""
    if pt is None:
        x, y, flags = 0, 0, FLAG_INFINITY
    else:
        x, y = pt
        flags = FLAG_Y_NEG if _is_neg(y, p) else 0
    if compress:
        return _ser_fp(x, p, flags)
    return _ser_fp(x, p) + _ser_fp(y, p, flags)


def _g2_subgroup_ok(c: CurveParams, pt) -> bool:
    """G2 subgroup membership: native batch scalar-mul when available,
    Python point loop otherwise (ark-serialize Validate::Yes)."""
    from groth16_tpu_torch.native import native_pairing
    from groth16_tpu_torch.ref import curve as rc

    nat = native_pairing(c.name)
    if nat is not None:
        return nat.g2_subgroup_check([pt]) == 0
    a2 = getattr(c, "a2", None)
    if c.g2_over_base:
        return rc.mul_fp(c.p, pt, c.r) is None
    from groth16_tpu_torch.ref.group import g2_field_ctx

    return rc.mul_fp2(g2_field_ctx(c), c.b2, pt, c.r, A2=a2) is None


def _de_fp_point(r: io.BytesIO, c: CurveParams, b: int, compress: bool,
                 validate: bool):
    """Deserialize an affine Fq-coordinate point on y^2 = x^3 + b."""
    p = c.p
    n = _nbytes(p)
    if compress:
        x, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        rhs = (x * x % p * x + b) % p
        y = F.sqrt_fp(rhs, p)
        if y is None:
            raise SerializationError("x not on curve")
        neg = (p - y) % p
        y_big, y_small = max(y, neg), min(y, neg)
        y = y_big if flags & FLAG_Y_NEG else y_small
    else:
        x, _ = _de_fp(r.read(n), p, False)
        y, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
    pt = (x, y)
    if validate:
        from groth16_tpu_torch.ref import curve as rc

        if not rc.is_on_curve_fp(p, b, pt):
            raise SerializationError("point not on curve")
        if not _g2_subgroup_ok(c, pt):
            raise SerializationError("point not in subgroup")
    return pt


def ser_g2(pt, c: CurveParams, compress: bool = True) -> bytes:
    if c.g2_over_base:
        # bw6-family: G2 points are single-Fq affine pairs on y^2=x^3+b2
        return _ser_fp_point(pt, c.p, compress)
    if c.g2_field_degree == 3:
        return _ser_ext_point(pt, c, compress)
    p = c.p
    if pt is None:
        x, y, flags = (0, 0), (0, 0), FLAG_INFINITY
    else:
        x, y = pt
        # Fp2 sign: arkworks QuadExtField neg-compare is lexicographic
        # from the last coefficient down (c1 first, tie-break on c0).
        flags = FLAG_Y_NEG if _fp2_is_neg(y, p) else 0
    if compress:
        return _ser_fp(x[0], p) + _ser_fp(x[1], p, flags)
    return (
        _ser_fp(x[0], p)
        + _ser_fp(x[1], p)
        + _ser_fp(y[0], p)
        + _ser_fp(y[1], p, flags)
    )


def _ext_is_neg(y, p: int) -> bool:
    """arkworks ext-field ordering: compare coefficient-wise from the
    HIGHEST coefficient down."""
    ny = tuple((p - v) % p for v in y)
    return tuple(reversed(y)) > tuple(reversed(ny))


def _ser_ext_point(pt, c: CurveParams, compress: bool) -> bytes:
    """G2 codec for extension degree != 2 (mnt6: Fp3 coordinates)."""
    p = c.p
    deg = c.g2_field_degree
    if pt is None:
        x, y, flags = (0,) * deg, (0,) * deg, FLAG_INFINITY
    else:
        x, y = pt
        flags = FLAG_Y_NEG if _ext_is_neg(y, p) else 0
    out = b"".join(_ser_fp(v, p) for v in x[:-1]) + _ser_fp(
        x[-1], p, flags if compress else 0
    )
    if compress:
        return out
    out = b"".join(_ser_fp(v, p) for v in x)
    return out + b"".join(_ser_fp(v, p) for v in y[:-1]) + _ser_fp(y[-1], p, flags)


def _de_ext_point(r: io.BytesIO, c: CurveParams, compress: bool, validate: bool):
    from groth16_tpu_torch.ref import curve as rc
    from groth16_tpu_torch.ref.group import g2_field_ctx

    p = c.p
    n = _nbytes(p)
    deg = c.g2_field_degree
    kh = g2_field_ctx(c)
    A2 = getattr(c, "a2", None)
    if compress:
        comps = [_de_fp(r.read(n), p, False)[0] for _ in range(deg - 1)]
        last, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        x = tuple(comps + [last])
        rhs = kh.add(kh.mul(kh.sqr(x), x), c.b2)
        if A2 is not None:
            rhs = kh.add(rhs, kh.mul(A2, x))
        y = kh.sqrt(rhs)
        if y is None:
            raise SerializationError("x not on twist curve")
        neg = kh.neg(y)
        if _ext_is_neg(y, p) != bool(flags & FLAG_Y_NEG):
            y = neg
    else:
        x = tuple(_de_fp(r.read(n), p, False)[0] for _ in range(deg))
        comps = [_de_fp(r.read(n), p, False)[0] for _ in range(deg - 1)]
        last, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        y = tuple(comps + [last])
    pt = (x, y)
    if validate:
        if not rc.is_on_curve_fp2(kh, c.b2, pt, A2=A2):
            raise SerializationError("point not on twist curve")
        if not _g2_subgroup_ok(c, pt):
            raise SerializationError("point not in subgroup")
    return pt


def _fp2_is_neg(y: Tuple[int, int], p: int) -> bool:
    """y > -y in arkworks' QuadExtField ordering: compare c1, then c0."""
    c0, c1 = y
    n0, n1 = (p - c0) % p, (p - c1) % p
    return (c1, c0) > (n1, n0)


def de_g2(r: io.BytesIO, c: CurveParams, compress: bool = True, validate: bool = True):
    if c.g2_over_base:
        return _de_fp_point(r, c, c.b2 % c.p, compress, validate)
    if c.g2_field_degree == 3:
        return _de_ext_point(r, c, compress, validate)
    p = c.p
    n = _nbytes(p)
    k2 = F.Fp2Ctx(p, c.fp2_nonresidue)
    if compress:
        x0, _ = _de_fp(r.read(n), p, False)
        x1, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        x = (x0, x1)
        rhs = k2.add(k2.mul(k2.sqr(x), x), c.b2)
        if getattr(c, "a2", None) is not None:
            rhs = k2.add(rhs, k2.mul(c.a2, x))
        y = k2.sqrt(rhs)
        if y is None:
            raise SerializationError("x not on twist curve")
        neg = k2.neg(y)
        want_neg = bool(flags & FLAG_Y_NEG)
        if _fp2_is_neg(y, p) != want_neg:
            y = neg
    else:
        x0, _ = _de_fp(r.read(n), p, False)
        x1, _ = _de_fp(r.read(n), p, False)
        y0, _ = _de_fp(r.read(n), p, False)
        y1, flags = _de_fp(r.read(n), p, True)
        if flags & FLAG_INFINITY:
            return None
        x, y = (x0, x1), (y0, y1)
    pt = (x, y)
    if validate:
        from groth16_tpu_torch.ref import curve as rc

        a2 = getattr(c, "a2", None)
        if not rc.is_on_curve_fp2(k2, c.b2, pt, A2=a2):
            raise SerializationError("point not on twist curve")
        if not _g2_subgroup_ok(c, pt):
            raise SerializationError("point not in subgroup")
    return pt


# -- containers ----------------------------------------------------------------


def _ser_vec(items, ser_fn) -> bytes:
    out = len(items).to_bytes(8, "little")
    return out + b"".join(ser_fn(i) for i in items)


def _de_vec(r: io.BytesIO, de_fn) -> List:
    n = int.from_bytes(r.read(8), "little")
    return [de_fn(r) for _ in range(n)]


# -- protocol structs ------------------------------------------------------------


def serialize_proof(proof: Proof, compress: bool = True) -> bytes:
    c = get_curve(proof.curve)
    return (
        ser_g1(proof.a, c, compress)
        + ser_g2(proof.b, c, compress)
        + ser_g1(proof.c, c, compress)
    )


def deserialize_proof(data: bytes, curve: str, compress: bool = True,
                      validate: bool = True) -> Proof:
    c = get_curve(curve)
    r = io.BytesIO(data)
    a = de_g1(r, c, compress, validate)
    b = de_g2(r, c, compress, validate)
    cc = de_g1(r, c, compress, validate)
    if r.read(1):
        raise SerializationError("trailing bytes")
    return Proof(curve=curve, a=a, b=b, c=cc)


def serialize_verifying_key(vk: VerifyingKey, compress: bool = True) -> bytes:
    c = get_curve(vk.curve)
    return (
        ser_g1(vk.alpha_g1, c, compress)
        + ser_g2(vk.beta_g2, c, compress)
        + ser_g2(vk.gamma_g2, c, compress)
        + ser_g2(vk.delta_g2, c, compress)
        + _ser_vec(vk.gamma_abc_g1, lambda p: ser_g1(p, c, compress))
    )


def deserialize_verifying_key(data: bytes, curve: str, compress: bool = True,
                              validate: bool = True) -> VerifyingKey:
    c = get_curve(curve)
    r = io.BytesIO(data)
    vk = _de_vk(r, c, curve, compress, validate)
    if r.read(1):
        raise SerializationError("trailing bytes")
    return vk


def _de_vk(r, c, curve, compress, validate):
    return VerifyingKey(
        curve=curve,
        alpha_g1=de_g1(r, c, compress, validate),
        beta_g2=de_g2(r, c, compress, validate),
        gamma_g2=de_g2(r, c, compress, validate),
        delta_g2=de_g2(r, c, compress, validate),
        gamma_abc_g1=_de_vec(r, lambda rr: de_g1(rr, c, compress, validate)),
    )


def serialize_proving_key(pk: ProvingKey, compress: bool = True) -> bytes:
    c = get_curve(pk.vk.curve)
    g1 = lambda p: ser_g1(p, c, compress)
    g2 = lambda p: ser_g2(p, c, compress)
    return (
        serialize_verifying_key(pk.vk, compress)
        + g1(pk.beta_g1)
        + g1(pk.delta_g1)
        + _ser_vec(pk.a_query, g1)
        + _ser_vec(pk.b_g1_query, g1)
        + _ser_vec(pk.b_g2_query, g2)
        + _ser_vec(pk.h_query, g1)
        + _ser_vec(pk.l_query, g1)
    )


def deserialize_proving_key(data: bytes, curve: str, compress: bool = True,
                            validate: bool = True) -> ProvingKey:
    c = get_curve(curve)
    r = io.BytesIO(data)
    vk = _de_vk(r, c, curve, compress, validate)
    g1 = lambda rr: de_g1(rr, c, compress, validate)
    g2 = lambda rr: de_g2(rr, c, compress, validate)
    pk = ProvingKey(
        vk=vk,
        beta_g1=g1(r),
        delta_g1=g1(r),
        a_query=_de_vec(r, g1),
        b_g1_query=_de_vec(r, g1),
        b_g2_query=_de_vec(r, g2),
        h_query=_de_vec(r, g1),
        l_query=_de_vec(r, g1),
    )
    if r.read(1):
        raise SerializationError("trailing bytes")
    return pk


# -- GT elements / prepared verifying key ----------------------------------


def _flatten_ext(el) -> List[int]:
    """Depth-first Fp coefficient dump of a nested tower element — the
    order ark-serialize's QuadExtField/CubicExtField derives produce
    (c0 first, recursively)."""
    if isinstance(el, tuple):
        out: List[int] = []
        for x in el:
            out.extend(_flatten_ext(x))
        return out
    return [el]


def _unflatten_ext(template, it):
    if isinstance(template, tuple):
        return tuple(_unflatten_ext(t, it) for t in template)
    return next(it)


def _gt_template(curve: str):
    """A GT identity element carrying the curve family's tower nesting
    (Fp12 for BLS/BN ate; Fp4/Fp6 for the Tate families)."""
    from groth16_tpu_torch.ref.pairing import make_pairing

    pair = make_pairing(curve)
    if hasattr(pair, "k12"):
        return pair.k12.one()
    return pair.kgt_one()


def ser_gt(el, c: CurveParams) -> bytes:
    """GT element -> bytes: recursive c0||c1(||c2) little-endian Fp dump
    (data_structures.rs:90 `alpha_g1_beta_g2: E::TargetField`).

    Basis parity with ark-ec (tests/test_gt_basis.py):
      * BLS/BN: the Fp12 2-over-3-over-2 tower in ark coefficient order.
      * Tate families: this engine's GT = Kh[v]/(v^2 - u) with
        Kh = Fq[u]/(u^d - nr) COINCIDES with ark-ec's tower — BW6/MNT6
        Fp6_2over3 and MNT4's Fp4 both set the quadratic-step
        nonresidue to u, and the registered Kh nonresidues (-4 / 17 / 5,
        curves/params.py) are the published ark config constants.  The
        flatten order (c0 coefficients then c1) matches QuadExtField's
        CanonicalSerialize.
    Caveat (PLAN.md): the VALUE serialized for a PreparedVerifyingKey's
    alpha_g1_beta_g2 is this engine's TATE pairing; ark-ec computes the
    ATE pairing for BW6/MNT, so PVK bytes are a local cache format for
    those families (ark's PVK also stores G2Prepared line coefficients,
    which this engine deliberately replaces with plain affine points —
    see serialize_prepared_verifying_key).  Proof/VK/PK — the actual
    interchange surface — are ark-format for all six curves."""
    return b"".join(_ser_fp(v, c.p) for v in _flatten_ext(el))


def de_gt(r: io.BytesIO, c: CurveParams, template):
    n = _nbytes(c.p)
    count = len(_flatten_ext(template))
    vals = iter(
        _de_fp(r.read(n), c.p, False)[0] for _ in range(count)
    )
    return _unflatten_ext(template, vals)


def serialize_prepared_verifying_key(pvk, compress: bool = True) -> bytes:
    """PreparedVerifyingKey -> bytes (data_structures.rs:88-97 field
    order: vk, alpha_g1_beta_g2, gamma/delta negations).  The reference
    stores the negations as G2Prepared line coefficients; this engine's
    pairing computes lines on the fly, so plain affine points are the
    prepared form — deserialization performs NO pairing (the cached
    e(alpha, beta) is the point of the type)."""
    c = get_curve(pvk.vk.curve)
    return (
        serialize_verifying_key(pvk.vk, compress)
        + ser_gt(pvk.alpha_g1_beta_g2, c)
        + ser_g2(pvk.gamma_g2_neg, c, compress)
        + ser_g2(pvk.delta_g2_neg, c, compress)
    )


def deserialize_prepared_verifying_key(
    data: bytes, curve: str, compress: bool = True, validate: bool = True
):
    from groth16_tpu_torch.protocol.data_structures import PreparedVerifyingKey

    c = get_curve(curve)
    r = io.BytesIO(data)
    vk = _de_vk(r, c, curve, compress, validate)
    gt = de_gt(r, c, _gt_template(curve))
    gamma_g2_neg = de_g2(r, c, compress, validate)
    delta_g2_neg = de_g2(r, c, compress, validate)
    if r.read(1):
        raise SerializationError("trailing bytes")
    return PreparedVerifyingKey(
        vk=vk,
        alpha_g1_beta_g2=gt,
        gamma_g2_neg=gamma_g2_neg,
        delta_g2_neg=delta_g2_neg,
    )
