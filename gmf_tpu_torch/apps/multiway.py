"""Multiway (pose-graph) registration.

Counterpart of ``gmf_tpu/apps/multiway.py`` (GMF_PointDSC/multiway/,
SURVEY.md P20): pairwise registration of fragments feeds a pose graph
(odometry + loop-closure edges), globally optimized with
Levenberg-Marquardt (the reference calls Open3D's GlobalOptimization,
multiway/optimize_posegraph.py:12-61); trajectory IO in the 3DMatch .log
format (multiway/trajectory.py) and ATE evaluation
(multiway/test_multi_ate.py).

The pose graph is a small host-side NumPy Gauss-Newton/LM problem in
f64 (a 6n x 6n system with numerical Jacobians, a few hundred nodes at
most), kept on the host as in ``gmf_tpu``. Robust loop-closure handling
uses Huber weights, the standard line-process approximation. Only
``ate_rmse``'s rigid alignment runs on a device (the port's Horn
quaternion ``kabsch_quat``, in f32 as ``gmf_tpu``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gmf_tpu_torch.geometry.kabsch import kabsch_quat
from gmf_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# se(3) exp/log (host)
# ---------------------------------------------------------------------------


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """xi = [rho(3), phi(3)] -> 4x4 (rotation-last convention)."""
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    W = _hat(phi)
    if th < 1e-10:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th ** 2
        C = (1 - A) / th ** 2
        R = np.eye(3) + A * W + B * (W @ W)
        V = np.eye(3) + B * W + C * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 -> xi = [rho, phi]."""
    R = T[:3, :3]
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-10:
        phi = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2
        Vinv = np.eye(3) - 0.5 * _hat(phi)
    else:
        phi = th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        W = _hat(phi)
        Vinv = (np.eye(3) - 0.5 * W
                + (1 / th ** 2 - (1 + np.cos(th)) / (2 * th * np.sin(th)))
                * (W @ W))
    rho = Vinv @ T[:3, 3]
    return np.concatenate([rho, phi])


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoseGraphEdge:
    i: int
    j: int
    trans: np.ndarray              # T_ij: maps frame j into frame i
    information: np.ndarray = None  # 6x6
    uncertain: bool = False        # loop closure (robustified)

    def __post_init__(self):
        if self.information is None:
            self.information = np.eye(6)


@dataclasses.dataclass
class PoseGraph:
    nodes: List[np.ndarray]        # absolute poses X_i (4x4)
    edges: List[PoseGraphEdge]


def _edge_residual(Xi, Xj, Tij):
    """r = log( T_ij^-1 · X_i^-1 · X_j ) in R^6."""
    return se3_log(np.linalg.inv(Tij) @ np.linalg.inv(Xi) @ Xj)


def optimize_pose_graph(graph: PoseGraph, max_iterations: int = 100,
                        huber_delta: float = 0.3,
                        damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton/LM over node poses with node 0 fixed.

    Loop-closure (uncertain) edges get Huber-downweighted each iteration —
    the practical equivalent of Open3D's line-process global optimization
    used by the reference.
    """
    n = len(graph.nodes)
    poses = [p.copy() for p in graph.nodes]
    lam = damping
    prev_cost = np.inf

    def total_cost():
        c = 0.0
        for e in graph.edges:
            r = _edge_residual(poses[e.i], poses[e.j], e.trans)
            c += float(r @ e.information @ r)
        return c

    for it in range(max_iterations):
        H = np.zeros((6 * n, 6 * n))
        b = np.zeros(6 * n)
        for e in graph.edges:
            r = _edge_residual(poses[e.i], poses[e.j], e.trans)
            w = 1.0
            if e.uncertain:
                nr = np.sqrt(max(float(r @ e.information @ r), 1e-12))
                w = 1.0 if nr <= huber_delta else huber_delta / nr
            # numerical Jacobians over the 12 local dofs (problem is tiny)
            J = np.zeros((6, 12))
            eps = 1e-6
            for k in range(6):
                d = np.zeros(6)
                d[k] = eps
                Pi = poses[e.i] @ se3_exp(d)
                J[:, k] = (_edge_residual(Pi, poses[e.j], e.trans) - r) / eps
                Pj = poses[e.j] @ se3_exp(d)
                J[:, 6 + k] = (_edge_residual(poses[e.i], Pj, e.trans) - r) / eps
            Wm = w * e.information
            idx = np.concatenate([np.arange(6 * e.i, 6 * e.i + 6),
                                  np.arange(6 * e.j, 6 * e.j + 6)])
            H[np.ix_(idx, idx)] += J.T @ Wm @ J
            b[idx] -= J.T @ Wm @ r

        # fix node 0 (gauge freedom)
        H[:6, :] = 0
        H[:, :6] = 0
        H[:6, :6] = np.eye(6)
        b[:6] = 0
        H += lam * np.eye(6 * n)

        try:
            dx = np.linalg.solve(H, b)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        for i in range(n):
            poses[i] = poses[i] @ se3_exp(dx[6 * i: 6 * i + 6])

        cost = total_cost()
        if abs(prev_cost - cost) < 1e-12 * max(prev_cost, 1.0):
            break
        lam = max(lam * 0.7, 1e-9) if cost < prev_cost else min(lam * 10, 1e2)
        prev_cost = cost

    return PoseGraph(nodes=poses, edges=graph.edges)


def multiway_register(fragments: Sequence, register_fn: Callable,
                      loop_closure_window: int = 0) -> PoseGraph:
    """Pairwise-register consecutive fragments (+ optional loop closures)
    and build/optimize the pose graph.

    register_fn(frag_i, frag_j) -> (T_ij 4x4, fitness float). Mirrors the
    reference's make_fragments/register pipeline structure
    (multiway/make_fragments.py:64-110).
    """
    n = len(fragments)
    nodes = [np.eye(4)]
    edges: List[PoseGraphEdge] = []
    for i in range(n - 1):
        T, fit = register_fn(fragments[i], fragments[i + 1])
        nodes.append(nodes[-1] @ T)
        edges.append(PoseGraphEdge(i, i + 1, T, np.eye(6) * max(fit, 1e-3)))
    for i in range(n):
        for j in range(i + 2, min(i + 2 + loop_closure_window, n)):
            T, fit = register_fn(fragments[i], fragments[j])
            if fit > 0.2:
                edges.append(PoseGraphEdge(
                    i, j, T, np.eye(6) * fit, uncertain=True))
    return optimize_pose_graph(PoseGraph(nodes=nodes, edges=edges))


# ---------------------------------------------------------------------------
# Trajectory IO + ATE (multiway/trajectory.py, test_multi_ate.py)
# ---------------------------------------------------------------------------


def read_trajectory(path: str) -> List[Tuple[Tuple[int, int, int], np.ndarray]]:
    """Read a 3DMatch .log trajectory: metadata triple + 4x4 per block."""
    out = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 4 < len(lines) or (i + 4 == len(lines) and len(lines) >= 5):
        meta = tuple(int(x) for x in lines[i].split()[:3])
        mat = np.array([[float(x) for x in lines[i + r].split()]
                        for r in range(1, 5)])
        out.append((meta, mat))
        i += 5
    return out


def write_trajectory(path: str,
                     traj: Sequence[Tuple[Tuple[int, int, int], np.ndarray]]):
    with open(path, "w") as f:
        for meta, mat in traj:
            f.write(" ".join(str(m) for m in meta) + "\n")
            for row in mat:
                f.write(" ".join(f"{v:.8f}" for v in row) + "\n")


def ate_rmse(est_poses: Sequence[np.ndarray],
             gt_poses: Sequence[np.ndarray], align: bool = True,
             device=None) -> float:
    """Absolute trajectory error (RMSE of translations, optionally after
    a rigid alignment of the two trajectories on ``device``, the card
    unless "cpu")."""
    est = np.stack([p[:3, 3] for p in est_poses])
    gt = np.stack([p[:3, 3] for p in gt_poses])
    if align and len(est) >= 3:
        dev = resolve_device(device)
        T = kabsch_quat(
            torch.tensor(est[None], dtype=torch.float32, device=dev),
            torch.tensor(gt[None], dtype=torch.float32, device=dev)
        )[0].cpu().numpy()
        est = est @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
