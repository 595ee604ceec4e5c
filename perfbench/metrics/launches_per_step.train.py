"""Device kernel launches in the traced window over the training steps it
took (layer: trainer; moves train_pairs_per_s)."""


def read(trace):
    steps = trace.counts.get("steps", 0)
    if not steps or not trace.kernels:
        return None
    return trace.kernels / steps
