from groth16_tpu_torch.serde.canonical import (  # noqa: F401
    deserialize_prepared_verifying_key,
    deserialize_proof,
    deserialize_proving_key,
    deserialize_verifying_key,
    serialize_prepared_verifying_key,
    serialize_proof,
    serialize_proving_key,
    serialize_verifying_key,
)
