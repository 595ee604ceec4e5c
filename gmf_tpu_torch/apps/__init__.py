"""Applications built on the port.

Counterpart of ``gmf_tpu/apps/``:
- multiway.py: multiway (pose-graph) registration — the reference's
  GMF_PointDSC/multiway/ app (SURVEY.md §2.2 P20): pairwise registration
  -> pose graph -> Levenberg-Marquardt/Gauss-Newton global optimization,
  trajectory IO and ATE evaluation;
- tsdf.py and make_fragments.py: depth frames -> TSDF-fused fragments on
  the device; multiway_cli.py: a scene's fragments -> trajectory and ATE.
"""

from gmf_tpu_torch.apps.multiway import (
    PoseGraph,
    optimize_pose_graph,
    multiway_register,
    read_trajectory,
    write_trajectory,
    ate_rmse,
)
