"""Device kernel launches in the traced window over the pairs it
registered (layer: registrar; moves pairs_per_s)."""


def read(trace):
    pairs = trace.counts.get("pairs", 0)
    if not pairs or not trace.kernels:
        return None
    return trace.kernels / pairs
