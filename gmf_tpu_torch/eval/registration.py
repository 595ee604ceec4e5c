"""PointDSC registration service: bucketed, batched test-mode inference.

Counterpart of ``gmf_tpu/eval/registration.py``, on one device or over a
mesh of ranks. Each
request, of any number of pairs (the reference's bench sends 64), pads its
pairs to one shared bucket and runs one batched forward on the model's
device in the model's modes. Two kinds of pair:

- precomputed correspondences (``corr_pos``, keypoints, both images): the
  result per pair is ``(trans [4, 4], labels [n])``;
- raw descriptors (``src_keypts``/``src_desc``, ``tgt_keypts``/
  ``tgt_desc``, both images, ``gt_trans``; no ``corr_pos``): the mutual
  1-NN matching, the ground-truth labels and the ``corr_pos`` encoding
  run on the device in the same call as the model
  (``data/correspondence.py::match_descriptors_device``), and the fetch
  writes the matched rows back into each sample dict, rebuilt on the host
  from the host's own copies, so the statistics that follow see what the
  host-matching path gives. With a ``DeviceFragmentCache`` and fragment
  keys (``src_key``/``tgt_key``) each fragment crosses to the device once.

``dispatch_batch``/``fetch_batch`` split a request as the reference's
harness pipelines it. ``dispatch_batch`` adds no host sync of its own
(its copies to the card leave from pinned memory without blocking), but
the model's forward still syncs in its post-refinement loop (a read
of the stopping rule every round, 24 syncs a request; PERF.md section 5),
so dispatch returns only once the forward is through that loop, and the
overlap of one request's device work with the host's handling of the
last one that the JAX split buys is not there yet.

With a ``mesh`` (``parallel/mesh.py``) every rank builds the registrar
and makes the same calls on the same samples. A batch is padded to a
multiple of the mesh's n_data with copies of sample 0, as gmf_tpu pads
it; ``dispatch_batch`` runs this rank's rows inside
``parallel.sharded`` (the model's batch-wide decisions and its cache
gate taken over the whole batch, as gmf_tpu's sharded trace takes them)
and ``fetch_batch`` all-gathers the rows and returns them in input
order. A single precomputed pair (``__call__``) runs unsharded on every
rank, as gmf_tpu's does.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gmf_tpu_torch.data.collate import BUCKETS, next_bucket, pad_to_bucket
from gmf_tpu_torch.data.correspondence import match_descriptors_device
from gmf_tpu_torch.parallel.collectives import all_gather_rows
from gmf_tpu_torch.parallel.mesh import replicate, sharded
from gmf_tpu_torch.utils.lru import ByteLRU


def _to_device(array, device) -> torch.Tensor:
    """A host array on ``device``. To the card through pinned memory and a
    non-blocking copy: a copy from pageable memory waits for the stream,
    which would make every request wait for the one before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DeviceFragmentCache:
    """Fragments held on the device for the raw-descriptor path.

    A fragment takes part in many pairs (3DMatch's redkitchen: 60
    fragments, 506 pairs), and the reference re-reads and re-sends both
    fragments of every pair. Here each fragment's padded (keypts, desc,
    mask) and image move to the device once, and a request is a stack of
    cached tensors: what crosses per request is the [4, 4] ground truth.

    Keys are (fragment id, bucket, device); least-recently-used entries
    leave first when the entries' host bytes pass ``max_bytes``.
    Thread-safe (``utils/lru.py``).
    """

    def __init__(self, max_bytes: int = 4 << 30):
        self._lru = ByteLRU(max_bytes)

    def get(self, key, build, device):
        """The cached dict of tensors on ``device`` for ``key``, built on a
        miss from ``build() -> dict of host arrays``."""
        device = torch.device(device)

        def build_entry():
            host = build()
            nbytes = sum(np.asarray(x).nbytes for x in host.values())
            return {k: _to_device(v, device) for k, v in host.items()}, nbytes

        return self._lru.get((key, str(device)), build_entry)

    @property
    def hits(self):
        return self._lru.hits

    @property
    def misses(self):
        return self._lru.misses

    @property
    def nbytes(self):
        return self._lru.nbytes

    def __len__(self):
        return len(self._lru)


def _pad_rows(x, bucket: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    out = np.zeros((bucket,) + x.shape[1:], np.float32)
    out[: len(x)] = x
    return out


def _fragment(sample, prefix: str, bucket: int) -> Dict[str, np.ndarray]:
    """One side of a raw pair, padded to ``bucket``: keypts, desc, mask
    and its image."""
    k = np.asarray(sample[prefix + "_keypts"], np.float32)
    return {
        "keypts": _pad_rows(k, bucket),
        "desc": _pad_rows(sample[prefix + "_desc"], bucket),
        "mask": (np.arange(bucket) < len(k)).astype(np.float32),
        "image": np.asarray(
            sample["p_image" if prefix == "src" else "q_image"], np.float32),
    }


class PointDSCRegistrar:
    """Serves a PointDSC model (eval mode) on its own device.

    ``buckets``: the correspondence-count buckets; a pair above the
    largest opens a bucket of the next multiple of 4096 (never
    subsampled). ``match_*``: the raw-descriptor path's inlier threshold
    for the ground-truth labels, mutual check and ``corr_pos`` encoding
    (the model's ``in_dim``). ``frag_cache``: a ``DeviceFragmentCache``
    for raw pairs that carry fragment keys. ``mesh``: shard batches over
    its 'data' axis (module docstring); rank 0's weights are broadcast
    once, and a model whose ``compat_cache_shards`` is 1 takes n_data
    there (a shallow copy sharing the weights), as gmf_tpu's registrar
    clones it.
    """

    def __init__(self, model, buckets: Sequence[int] = BUCKETS, mesh=None,
                 match_inlier_threshold: float = 0.10,
                 match_mutual: bool = True, match_in_dim: int = 6,
                 frag_cache: Optional[DeviceFragmentCache] = None):
        if mesh is not None and mesh.n_data > 1 and getattr(
                model, "compat_cache_shards", 0) == 1:
            model = copy.copy(model)
            model.compat_cache_shards = mesh.n_data
        if mesh is not None:
            replicate(model, mesh)
        self.mesh = mesh
        self._n_data = 1 if mesh is None else mesh.n_data
        self.model = model.eval()
        self.buckets = tuple(buckets)
        self.match_inlier_threshold = match_inlier_threshold
        self.match_mutual = match_mutual
        self.match_in_dim = match_in_dim
        self.frag_cache = frag_cache

    @property
    def device(self):
        return self.model.device

    def _bucket_for(self, n: int) -> int:
        buckets = list(self.buckets)
        if n > max(buckets):
            # never subsample at eval time: open a larger bucket instead
            buckets.append(-(-n // 4096) * 4096)
        return next_bucket(n, buckets)

    def _pad_one(self, sample: Dict[str, np.ndarray], bucket: int):
        return pad_to_bucket(
            {k: sample[k] for k in
             ("corr_pos", "src_keypts", "tgt_keypts", "labels")
             if k in sample}, [bucket])

    def _tensor(self, arrays) -> torch.Tensor:
        return _to_device(np.stack([np.asarray(a, np.float32)
                                    for a in arrays]), self.device)

    def __call__(self, sample: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """One pair, either kind: (trans [4, 4], labels). Over a mesh a
        precomputed pair runs whole on every rank, a raw one sharded."""
        (trans, labels), = self.fetch_batch(self._dispatch(
            [sample], shard="corr_pos" not in sample))
        return trans, labels

    def _rows(self, n: int, shard: bool) -> List[int]:
        """The sample indices this rank runs for a batch of ``n``: all of
        them, or its slice of them padded to a multiple of n_data with
        copies of sample 0."""
        if not shard or self._n_data == 1:
            return list(range(n))
        b = -(-n // self._n_data) * self._n_data
        idx = list(range(n)) + [0] * (b - n)
        per = b // self._n_data
        at = self.mesh.index["data"] * per
        return idx[at:at + per]

    def _gather(self, x: torch.Tensor, shard: bool) -> torch.Tensor:
        """Every rank's rows of ``x`` in batch order (bool rows travel as
        bytes)."""
        if not shard or self._n_data == 1:
            return x
        if x.dtype == torch.bool:
            return all_gather_rows(x.to(torch.uint8), self.mesh).bool()
        return all_gather_rows(x, self.mesh)

    def eval_bucket(self, samples: Sequence[Dict[str, np.ndarray]]):
        """The bucket a group of samples batches into: one size for
        precomputed correspondences, (source, target) sizes for raw
        pairs."""
        if "corr_pos" in samples[0]:
            return self._bucket_for(
                max(s["corr_pos"].shape[0] for s in samples))
        return (self._bucket_for(
                    max(s["src_keypts"].shape[0] for s in samples)),
                self._bucket_for(
                    max(s["tgt_keypts"].shape[0] for s in samples)))

    def register_batch(self, samples: Sequence[Dict[str, np.ndarray]]
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Register several pairs in one forward; results in input
        order."""
        return self.fetch_batch(self.dispatch_batch(samples))

    def dispatch_batch(self, samples: Sequence[Dict[str, np.ndarray]]):
        """Start one batched forward and return a handle for
        ``fetch_batch`` (module docstring on what the split overlaps;
        over a mesh, this rank's rows)."""
        return self._dispatch(samples, shard=True)

    def _dispatch(self, samples, shard: bool):
        if not samples:
            return ("empty",)
        if "corr_pos" not in samples[0]:
            return self._dispatch_batch_raw(samples, shard)
        bucket = self.eval_bucket(samples)
        rows = self._rows(len(samples), shard)
        padded = [self._pad_one(samples[i], bucket) for i in rows]
        mesh = self.mesh if shard else None
        with torch.inference_mode(), sharded(mesh):
            out = self.model(
                self._tensor(p["corr_pos"] for p in padded),
                self._tensor(p["src_keypts"] for p in padded),
                self._tensor(p["tgt_keypts"] for p in padded),
                self._tensor(samples[i]["p_image"] for i in rows),
                self._tensor(samples[i]["q_image"] for i in rows),
                testing=True,
                corr_mask=self._tensor(p["corr_mask"] for p in padded))
        return ("corr", samples, bucket, out["final_trans"],
                out["final_labels"], shard)

    def fetch_batch(self, handle) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Wait for a ``dispatch_batch`` handle and unpack per-pair
        results (the raw path also writes the matched rows back into the
        sample dicts)."""
        kind = handle[0]
        if kind == "empty":
            return []
        if kind == "raw":
            return self._fetch_batch_raw(handle)
        _, samples, bucket, trans, labels, shard = handle
        trans = self._gather(trans, shard).cpu().numpy()
        labels = self._gather(labels, shard).cpu().numpy()
        return [(trans[i], labels[i][:min(s["corr_pos"].shape[0], bucket)])
                for i, s in enumerate(samples)]

    def _dispatch_batch_raw(self, samples: Sequence[Dict[str, np.ndarray]],
                            shard: bool = True):
        bs, bt = self.eval_bucket(samples)
        cache = self.frag_cache
        cached = cache is not None and all(
            "src_key" in s and "tgt_key" in s for s in samples)
        mine = [samples[i] for i in self._rows(len(samples), shard)]

        def side(prefix, bucket):
            """One side of this rank's rows as a dict of [B, ...]
            tensors."""
            if not cached:
                entries = [_fragment(s, prefix, bucket) for s in mine]
                return {k: self._tensor(e[k] for e in entries)
                        for k in entries[0]}
            # each fragment's tensors cross to the device once
            entries = [cache.get((s[prefix + "_key"], bucket),
                                 lambda s=s: _fragment(s, prefix, bucket),
                                 self.device) for s in mine]
            return {k: torch.stack([e[k] for e in entries])
                    for k in entries[0]}

        src, tgt = side("src", bs), side("tgt", bt)
        gt = self._tensor(s["gt_trans"] for s in mine)
        return ("raw", samples, self._register_raw(src, tgt, gt, shard),
                shard)

    def _register_raw(self, src, tgt, gt, shard: bool = False):
        """Matching and the model in one call: (final_trans, final_labels,
        ground-truth labels > 0, corr_mask > 0, src_idx), on the device."""
        with torch.inference_mode(), sharded(self.mesh if shard else None):
            m = match_descriptors_device(
                src["keypts"], tgt["keypts"], src["desc"], tgt["desc"], gt,
                self.match_inlier_threshold, src["mask"], tgt["mask"],
                use_mutual=self.match_mutual, in_dim=self.match_in_dim)
            out = self.model(m["corr_pos"], m["src_keypts"], m["tgt_keypts"],
                             src["image"], tgt["image"], testing=True,
                             corr_mask=m["corr_mask"])
        # a compact fetch: labels and mask as bool, int32 match indices
        return (out["final_trans"], out["final_labels"], m["labels"] > 0,
                m["corr_mask"] > 0, m["src_idx"])

    def _fetch_batch_raw(self, handle) -> List[Tuple[np.ndarray, np.ndarray]]:
        _, samples, res, shard = handle
        trans, pred, gt_labels, cmask, src_idx = (
            self._gather(x, shard).cpu().numpy() for x in res)
        out = []
        for row, s in enumerate(samples):
            valid = cmask[row]
            src_k = np.asarray(s["src_keypts"], np.float32)
            tgt_k = np.asarray(s["tgt_keypts"], np.float32)
            vn = valid[: len(src_k)]
            # the device took src * mask and tgt[src_idx] * mask from
            # copies of these arrays, so indexing here rebuilds them
            s["src_keypts"] = src_k[vn]
            s["tgt_keypts"] = tgt_k[src_idx[row][: len(src_k)][vn]]
            s["labels"] = gt_labels[row][: len(src_k)][vn].astype(np.float32)
            s.pop("corr_mask", None)
            # the sample now holds matched rows: drop its fragment keys, so
            # that dispatching it again cannot hit the whole fragments
            s.pop("src_key", None)
            s.pop("tgt_key", None)
            out.append((trans[row], pred[row][valid]))
        return out
