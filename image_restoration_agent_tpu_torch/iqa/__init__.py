from .metrics import psnr, ssim
from .scorer import Scorer
from .classifier import (DEGRADATIONS, EVALUATED_DEGRADATIONS,
                         SEVERITY_LEVELS, DegradationClassifier,
                         DegradationClassifierV3, DegradationClassifierV5,
                         SeverityEvaluator, degradation_features)

__all__ = ["psnr", "ssim", "Scorer", "DEGRADATIONS",
           "EVALUATED_DEGRADATIONS", "SEVERITY_LEVELS",
           "DegradationClassifier", "DegradationClassifierV3",
           "DegradationClassifierV5", "SeverityEvaluator",
           "degradation_features"]
