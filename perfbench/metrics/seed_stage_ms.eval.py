"""Device ms a request from the end of ``model.encoder`` to the end of the
model's forward (the seed stage and the post-refinement), from the
benchmark's CUDA events at those hooks; the mean over the traced window's
requests (layer: seed stage; moves pairs_per_s)."""


def read(trace):
    ms = [f["after_encoder_ms"] for f in trace.forwards]
    return sum(ms) / len(ms) if ms else None
