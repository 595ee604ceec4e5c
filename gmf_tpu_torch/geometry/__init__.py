"""Geometry and math primitives (counterpart of ``gmf_tpu/geometry``,
whose exports these are)."""

from gmf_tpu_torch.geometry.kabsch import (kabsch_quat, kabsch_svd,
                                           rigid_transform_3d)
from gmf_tpu_torch.geometry.knn import knn, pdist
from gmf_tpu_torch.geometry.metrics import (registration_success,
                                            rotation_error_deg,
                                            translation_error)
from gmf_tpu_torch.geometry.nms import pick_seeds_nms
from gmf_tpu_torch.geometry.se3 import (concatenate, decompose_trans,
                                        integrate_trans, inverse,
                                        random_rotation_matrix,
                                        random_translation, transform)
from gmf_tpu_torch.geometry.spectral import leading_eigenvector
