"""The encoder's least time (its products at the peak rate, or its bytes
at the peak bandwidth, whichever is larger; ``perfbench/counts.py``) over
its device time from the benchmark's CUDA events on ``model.encoder``, in
percent, over the traced window's requests (layer: encoder; moves
pairs_per_s)."""

from perfbench import counts


def read(trace):
    work, fwd = trace.work, trace.forwards
    if not fwd or len(work.get("valid", [])) < len(fwd):
        return None
    least = sum(counts.encoder_least_s(work["config"], valid,
                                       work["image_hw"])
                for valid in work["valid"][:len(fwd)])
    spent = sum(f["encoder_ms"] for f in fwd) / 1e3
    return 100.0 * least / spent if spent > 0 else None
