"""Offline analysis of saved eval stats.

Counterpart of ``gmf_tpu/tools/analyze_stats.py``, NumPy on the host, the
same code (GMF_DGR scripts/analyze_stats.py): recall / RE / TE / timing
summaries, per-scene breakdowns, and precision-recall threshold curves.
Consumes both the 12-column .npy stats the evaluation command lines write
(``eval/harness.py``) and the reference's multi-method results.npz
artifact (``names`` [M] + ``stats`` [M, num_pairs, 5] with columns
success/TE/RE/time/scene, the format of
``GMF_DGR_fcgf/assets/results.npz``). ``--plot`` needs matplotlib and
says so where it is absent.

Usage:
  python -m gmf_tpu_torch.tools.analyze_stats stats.npy [stats2.npy ...]
  python -m gmf_tpu_torch.tools.analyze_stats results.npz [--plot PREFIX]
"""

from __future__ import annotations

import argparse

import numpy as np


def analyze_by_pair(stats: np.ndarray, rte_thresh: float,
                    rre_thresh: float) -> np.ndarray:
    """[M, num_pairs, 5] -> [M, 4] (recall, TE, RE, time over valid
    pairs). Exact mirror of scripts/analyze_stats.py::analyze_by_pair."""
    num_methods = stats.shape[0]
    out = np.zeros((num_methods, 4))
    for m in range(num_methods):
        valid = (stats[m, :, 1] < rte_thresh) & (stats[m, :, 2] < rre_thresh)
        out[m, 0] = valid.mean()
        out[m, 1] = stats[m, valid, 1].mean() if valid.any() else np.nan
        out[m, 2] = stats[m, valid, 2].mean() if valid.any() else np.nan
        out[m, 3] = stats[m, valid, 3].mean() if valid.any() else np.nan
    return out


def analyze_by_scene(stats: np.ndarray, scene_id_list,
                     rte_thresh: float = 0.3,
                     rre_thresh: float = 15.0) -> np.ndarray:
    """[M, num_pairs, 5] -> [M, S, 4] per-scene aggregates (exact mirror
    of scripts/analyze_stats.py::analyze_by_scene)."""
    num_methods = stats.shape[0]
    out = np.zeros((num_methods, len(scene_id_list), 4))
    for m in range(num_methods):
        valid = (stats[m, :, 1] < rte_thresh) & (stats[m, :, 2] < rre_thresh)
        for si, s in enumerate(scene_id_list):
            in_scene = stats[m, :, 4] == s
            mask = in_scene & valid
            out[m, si, 0] = (0.0 if in_scene.sum() == 0
                             else mask.sum() / in_scene.sum())
            out[m, si, 1] = stats[m, mask, 1].mean() if mask.any() else np.nan
            out[m, si, 2] = stats[m, mask, 2].mean() if mask.any() else np.nan
            out[m, si, 3] = stats[m, mask, 3].mean() if mask.any() else np.nan
    return out


def precision_recall_curves(stats: np.ndarray, rte_precisions,
                            rre_precisions):
    """Recall-vs-threshold curves (the data behind the reference's
    plot_precision_recall_curves). Returns (rre_curves [M, len(rre)],
    rte_curves [M, len(rte)])."""
    M = stats.shape[0]
    rre_curves = np.zeros((M, len(rre_precisions)))
    rte_curves = np.zeros((M, len(rte_precisions)))
    for i, rre in enumerate(rre_precisions):
        rre_curves[:, i] = analyze_by_pair(stats, np.inf, rre)[:, 0]
    for i, rte in enumerate(rte_precisions):
        rte_curves[:, i] = analyze_by_pair(stats, rte, np.inf)[:, 0]
    return rre_curves, rte_curves


def summarize_methods(names, stats: np.ndarray, rte_thresh: float = 0.3,
                      rre_thresh: float = 15.0) -> str:
    """Method-comparison table for a reference-format results tensor."""
    agg = analyze_by_pair(stats, rte_thresh, rre_thresh)
    lines = [f"{'method':>22}  recall    TE (m)  RE (deg)  time (s)"]
    for n, row in zip(names, agg):
        lines.append(f"{str(n):>22}  {row[0] * 100:5.2f}%  {row[1]:.4f}"
                     f"  {row[2]:8.3f}  {row[3]:8.4f}")
    return "\n".join(lines)


def summarize(stats: np.ndarray) -> str:
    ok = stats[stats[:, 0] == 1]
    lines = [
        f"pairs: {len(stats)}  recall: {stats[:, 0].mean() * 100:.2f}%",
        (f"RE (success only): {ok[:, 1].mean():.3f} deg  "
         f"TE: {ok[:, 2].mean():.3f} cm" if len(ok) else "no successes"),
        (f"inliers in: {stats[:, 3].mean():.1f} "
         f"(ratio {stats[:, 4].mean() * 100:.2f}%)  "
         f"out: {stats[:, 5].mean():.1f}"),
        (f"precision: {stats[:, 6].mean() * 100:.2f}%  "
         f"recall: {stats[:, 7].mean() * 100:.2f}%  "
         f"f1: {stats[:, 8].mean() * 100:.2f}%"),
        (f"model time: {stats[:, 9].mean():.4f}s  "
         f"data time: {stats[:, 10].mean():.4f}s  "
         f"pairs/sec (model): {1.0 / max(stats[:, 9].mean(), 1e-9):.2f}"),
    ]
    # per-scene breakdown when multiple scene indices present
    scenes = np.unique(stats[:, 11])
    if len(scenes) > 1:
        for s in scenes:
            sub = stats[stats[:, 11] == s]
            lines.append(f"  scene {int(s)}: recall "
                         f"{sub[:, 0].mean() * 100:.2f}% ({len(sub)} pairs)")
    return "\n".join(lines)


def _plot(names, stats, prefix: str):  # pragma: no cover - optional viz
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    rre_p = np.arange(1, 16, 0.5)
    rte_p = np.arange(0.05, 0.35, 0.01)
    rre_c, rte_c = precision_recall_curves(stats, rte_p, rre_p)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3))
    for m, n in enumerate(names):
        ax1.plot(rre_p, rre_c[m], label=str(n))
        ax2.plot(rte_p, rte_c[m])
    ax1.set_xlabel("Rotation (deg)")
    ax1.set_ylabel("Recall")
    ax2.set_xlabel("Translation (m)")
    for ax in (ax1, ax2):
        ax.set_ylim(0, 1)
        ax.grid()
    ax1.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(f"{prefix}_precision_recall.png")
    plt.close(fig)
    print(f"wrote {prefix}_precision_recall.png")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stats", nargs="+")
    ap.add_argument("--rte", type=float, default=0.3)
    ap.add_argument("--rre", type=float, default=15.0)
    ap.add_argument("--plot", metavar="PREFIX", default=None,
                    help="write precision-recall curve plots (npz input)")
    args = ap.parse_args(argv)
    for path in args.stats:
        print(f"== {path} ==")
        if path.endswith(".npz"):
            d = np.load(path, allow_pickle=True)
            names, stats = d["names"], d["stats"]
            print(summarize_methods(names, stats, args.rte, args.rre))
            scenes = np.unique(stats[0, :, 4]).astype(int)
            by_scene = analyze_by_scene(stats, scenes, args.rte, args.rre)
            for m, n in enumerate(names):
                recs = " ".join(f"{r * 100:5.1f}" for r in by_scene[m, :, 0])
                print(f"  {str(n):>22} scene recalls: {recs}")
            if args.plot:
                _plot(names, stats, args.plot)
        else:
            print(summarize(np.load(path)))


if __name__ == "__main__":
    main()
