"""In-circuit (R1CS) gadget library + Groth16 verifier gadget (L7).

The TPU-native analog of `ark-r1cs-std` + arkworks-rs/groth16 src/constraints.rs:
verify a Groth16 proof over an INNER pairing-friendly curve inside a
constraint system whose native field is the inner curve's BASE field —
the one-layer recursion setting.  Primary instantiation: BLS12-377
proofs verified inside BW6-761 circuits (the composition BW6-761 was
built for; the reference exercises the same gadget API on the
MNT4-298/MNT6-298 cycle, constraints.rs:452-589, which this library
also supports for MNT4-inside-MNT6).
"""

from groth16_tpu_torch.gadgets.groth16_var import (  # noqa: F401
    Groth16VerifierGadget,
    PreparedVerifyingKeyVar,
    ProofVar,
    VerifyingKeyVar,
)
from groth16_tpu_torch.gadgets.r1cs_std import Boolean, FpVar  # noqa: F401
