"""The model's counted products (encoder, confidence MLP, the seed
stage's kNN and neighbourhood matrices; ``perfbench/counts.py``) of every
request of the traced window, over the window's seconds and the peak
rate, in percent (layer: model step; moves pairs_per_s)."""

from perfbench import counts


def read(trace):
    work = trace.work
    if not trace.window_s or not work.get("valid"):
        return None
    flops = sum(counts.model_flops(work["config"], n, work["bucket"],
                                   work["image_hw"])
                for valid in work["valid"] for n in valid)
    return 100.0 * flops / (trace.window_s * counts.PEAK_FLOPS)
