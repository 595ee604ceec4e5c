"""PointDSC registration service: bucketed, batched test-mode inference.

Counterpart of ``gmf_tpu/eval/registration.py::PointDSCRegistrar`` for
samples with precomputed correspondences (``corr_pos``, keypoints and
both images). Each request, of any number of samples (the reference's
bench sends 64), pads its samples to one shared bucket, runs one batched
forward on the model's device in the model's ``compat_cache`` and
``seed_solver`` modes, and returns per-sample ``(trans [4, 4], labels
[n])``. The JAX registrar's mesh sharding,
raw-descriptor matching and fragment cache are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gmf_tpu_torch.data.collate import BUCKETS, next_bucket, pad_to_bucket


class PointDSCRegistrar:
    """Serves a PointDSC model (eval mode) on its own device."""

    def __init__(self, model, buckets: Sequence[int] = BUCKETS):
        self.model = model.eval()
        self.buckets = tuple(buckets)

    @property
    def device(self):
        return self.model.device

    def _bucket_for(self, n: int) -> int:
        buckets = list(self.buckets)
        if n > max(buckets):
            # never subsample at eval time: open a larger bucket instead
            buckets.append(-(-n // 4096) * 4096)
        return next_bucket(n, buckets)

    def __call__(self, sample: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        (trans, labels), = self.register_batch([sample])
        return trans, labels

    def register_batch(self, samples: Sequence[Dict[str, np.ndarray]]
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Register several pairs in one forward; results in input order."""
        if not samples:
            return []
        bucket = self._bucket_for(
            max(s["corr_pos"].shape[0] for s in samples))
        padded = [pad_to_bucket(
            {k: s[k] for k in ("corr_pos", "src_keypts", "tgt_keypts")},
            [bucket]) for s in samples]

        def stack(key, source):
            return torch.from_numpy(np.stack(
                [np.asarray(x[key], np.float32) for x in source])).to(
                    self.device)

        with torch.inference_mode():
            out = self.model(
                stack("corr_pos", padded), stack("src_keypts", padded),
                stack("tgt_keypts", padded), stack("p_image", samples),
                stack("q_image", samples), testing=True,
                corr_mask=stack("corr_mask", padded))
        trans = out["final_trans"].cpu().numpy()
        labels = out["final_labels"].cpu().numpy()
        return [(trans[i], labels[i][:min(s["corr_pos"].shape[0], bucket)])
                for i, s in enumerate(samples)]
