"""Losses: the detectors' criteria (``detr``, ``denoising``, ``yolo``) and
the signal domain's classification, masked regression, position and
heatmap losses, exported here as ``pautdx/losses/__init__.py`` exports
them."""

from pautdx_torch.losses.classification import (  # noqa: F401
    bce, bce_with_logits, cross_entropy, focal_bce_with_logits,
)
from pautdx_torch.losses.heatmap import (  # noqa: F401
    detloc_criterion, detloc_targets,
)
from pautdx_torch.losses.position import (  # noqa: F401
    detection_loss, detection_position_loss, enhanced_position_loss,
    position_accuracy_iou, seq_detector_loss, two_stage_loss,
)
from pautdx_torch.losses.regression import (  # noqa: F401
    focal_l1, interval_iou_1d, masked_iou_loss, masked_l1, masked_smooth_l1,
    temporal_consistency, uncertainty_regularizer,
)
