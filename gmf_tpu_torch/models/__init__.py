"""PointDSC+GMF in PyTorch (test-mode forward)."""

from gmf_tpu_torch.models.pointdsc import NonLocalBlock, NonLocalNet, PointDSC
