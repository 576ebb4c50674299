"""keygen_s: seconds of the proving key made on the device (the program's
protocol/generator_torch key generation, ending in a sync), on the
harness's clock; moves setup_s."""


def read(ctx):
    return ctx["spans"].get("keygen")
