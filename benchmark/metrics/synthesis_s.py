"""synthesis_s: seconds of the PROVE-mode synthesis and to_matrices
(r1cs/system; for the recursion circuit with the inner proof its witness
verifies), on the harness's clock; moves setup_s."""


def read(ctx):
    return ctx["spans"].get("synthesis")
