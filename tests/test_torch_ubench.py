"""Plain version of kernel V (utils/ubench.py) against the chains of
scripts/ubench_vpu.py written in jax.numpy: the same seven operations
(ubench_vpu.py:92-102) on the same inputs, N = 64 elements, R = 32 steps.
Integer operations agree word for word; f32 ones within F32_RTOL (the
order of operations is the same, only the CPU backends' fusing may differ).

The TPU script's chains run inside a Pallas kernel on its VPU; here the same
lambdas run as plain jax.numpy ops on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from groth16_tpu_torch.utils import ubench

N, R = 64, 32

# ubench_vpu.py:92-102, keyed by the port's operation names
JAX_OPS = {
    "u32_mul": (np.uint32, lambda x, y: x * y),
    "u32_add": (np.uint32, lambda x, y: x + y),
    "u32_cios": (np.uint32, lambda x, y: ((x * y) & 0x7FFF) + ((x * y) >> 15) + y),
    "u16_mul": (np.uint32, lambda x, y: (x & 0xFFFF) * (y & 0xFFFF)),
    "f32_mul": (np.float32, lambda x, y: x * y),
    "f32_fma": (np.float32, lambda x, y: x * y + y),
    "i32_mul": (np.int32, lambda x, y: x * y),
}


def _jax_chains(dtype, op, a, b):
    """ubench_vpu.py:40-53: four cross-coupled chains, R steps each."""
    x0, x1, x2, x3 = a, a + 1, a + 2, b
    for _ in range(R // 4):
        x0 = op(x0, x1)
        x1 = op(x1, x2)
        x2 = op(x2, x3)
        x3 = op(x3, x0)
    return x0 ^ x1 ^ x2 ^ x3 if dtype == np.uint32 else x0 + x1 + x2 + x3


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random(N, dtype=np.float32), rng.random(N, dtype=np.float32)
    # the whole 32-bit range, so every wrap-around is exercised
    return tuple(rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32).view(dtype) for _ in range(2))


@pytest.mark.parametrize("key", list(JAX_OPS))
def test_plain_chains_match_jax(key):
    dtype, op = JAX_OPS[key]
    a, b = _inputs(dtype, seed=len(key))
    want = np.asarray(jax.jit(lambda x, y: _jax_chains(dtype, op, x, y))(jnp.asarray(a), jnp.asarray(b)))
    to_torch = (lambda x: torch.from_numpy(x.view(np.int32))) if dtype != np.float32 else torch.from_numpy
    got = ubench.chains(key, to_torch(a), to_torch(b), R).numpy()  # CPU tensors: the plain version
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=ubench.F32_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got.view(dtype), want)


def test_wrapper_checks_and_has_no_fallback_off_the_cpu():
    a, b = ubench.inputs("u32_mul", 32, seed=1)
    assert torch.equal(ubench.chains("u32_mul", a, b, 16), ubench.chains_plain("u32_mul", a, b, 16))
    with pytest.raises(ValueError):
        ubench.chains("u32_mul", a, b, 24)  # R not a multiple of 16
    with pytest.raises(TypeError):
        ubench.chains("f32_mul", a, b, 16)  # int32 digits for a float op
    meta = a.to("meta")
    with pytest.raises(ValueError):
        ubench.chains("u32_mul", meta, meta, 16)


class _CountMultiplies(TorchFunctionMode):
    """Elementwise multiplies (mul, addcmul) of the torch calls run under
    it."""

    MULTIPLIES = {"mul", "mul_", "__mul__", "__rmul__", "__imul__", "addcmul", "addcmul_"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", None) in self.MULTIPLIES:
            self.count += out.numel()
        return out


def test_speed_of_light_counts_match_jax():
    """utils/profiling.py counts the multiply-adds of a Montgomery product
    -- exactly those the plain version of K1 runs per element -- and the
    JAX package's number of products per point addition; the rate is the
    caller's (V's measurement on the card), where the JAX package fixes a
    TPU one and also counts the adds and masks its VPU issues."""
    from groth16_tpu.utils import profiling as jprof
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields import cuda_fp
    from groth16_tpu_torch.fields.spec import make_spec
    from groth16_tpu_torch.utils import profiling

    n = cuda_fp.PLAIN_INT_MAX_N + 8  # the int64 CIOS (fewer elements run on Python ints)
    for modulus in (get_curve("bn254").p, get_curve("bls12_381").p):
        spec = make_spec(modulus)
        L = spec.n_limbs
        a = torch.randint(0, 1 << 15, (L, n), dtype=torch.int32, generator=torch.Generator().manual_seed(L))
        with _CountMultiplies() as counter:
            cuda_fp.mont_mul_plain(spec, a, a)
        assert counter.count == n * profiling.mont_mul_u32_ops(L)
        for fp2 in (False, True):
            # the JAX model: 13 products per mixed addition, plus 20 L
            # resolving operations per coordinate
            products = (jprof.point_add_u32_ops(L, fp2) - 20 * L * (2 if fp2 else 1)) // jprof.mont_mul_u32_ops(L)
            assert profiling.point_add_u32_ops(L, fp2) == products * profiling.mont_mul_u32_ops(L)
            assert profiling.point_add_u32_ops(L, fp2, mixed=False) == (products - (4 if fp2 else 1)) * profiling.mont_mul_u32_ops(L)
    assert not hasattr(profiling, "VPU_U32_OPS_PER_S")
