"""PointDSC+GMF in PyTorch: test mode and the train branch, every mode of
the reference but its ring path."""

from gmf_tpu_torch.models.pointdsc import NonLocalBlock, NonLocalNet, PointDSC
