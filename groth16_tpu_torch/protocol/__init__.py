from groth16_tpu_torch.protocol.data_structures import (
    Proof,
    ProvingKey,
    VerifyingKey,
    PreparedVerifyingKey,
)
from groth16_tpu_torch.protocol.generator import generate_parameters_with_qap, setup
from groth16_tpu_torch.protocol.prover import create_proof_with_reduction, prove, rerandomize_proof
from groth16_tpu_torch.protocol.verifier import (
    prepare_verifying_key,
    prepare_inputs,
    verify_proof,
    verify_proof_with_prepared_inputs,
)
from groth16_tpu_torch.protocol.absorb import (
    proof_to_field_elements,
    vk_hash,
    vk_to_field_elements,
    vk_to_sponge_bytes,
)
