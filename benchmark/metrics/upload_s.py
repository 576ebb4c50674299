"""upload_s: seconds of TorchProver(...), the key and the matrices
encoded and uploaded (protocol/device_keys, qap/device.encode_matrices),
ending in a sync, on the harness's clock; moves setup_s."""


def read(ctx):
    return ctx["spans"].get("upload")
