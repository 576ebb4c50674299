"""Port radix-2 NTT domain against the JAX package's exact engine
(`groth16_tpu.ref.domain.RefDomain`, the reference its own NttDomain is
tied to) on the CPU (bn254 Fr, n = 2^6 and 2^8).  Tolerance: equal mod p
(the port returns exact digits < 2p)."""

import random

import numpy as np
import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.ref.domain import RefDomain
from groth16_tpu_torch.fields.spec import decode, encode, make_spec
from groth16_tpu_torch.ntt.ntt import NttDomain

torch.set_num_threads(1)


@pytest.mark.parametrize("log_n", [6, 8])
@pytest.mark.parametrize("op", ["fft", "ifft", "coset_fft", "coset_ifft"])
def test_ntt_matches_jax(log_n, op):
    c = get_curve("bn254")
    n = 1 << log_n
    s = make_spec(c.r, name=c.fr.name)
    r = random.Random(log_n)
    vals = [r.randrange(c.r) for _ in range(n)]
    enc = encode(vals, s)

    dom = NttDomain(c.fr, n, device="cpu")
    got = decode(getattr(dom, op)(torch.from_numpy(enc.astype(np.int32))).numpy(), s)
    ref = RefDomain(c.fr, n)
    if op.startswith("coset_"):
        ref, op = ref.get_coset(c.fr.generator), op[len("coset_"):]
    assert got == getattr(ref, op)(list(vals))
