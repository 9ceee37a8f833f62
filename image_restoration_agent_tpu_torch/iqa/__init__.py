from .classifier import (DEGRADATIONS, EVALUATED_DEGRADATIONS,
                         SEVERITY_LEVELS, DegradationClassifierV3,
                         SeverityEvaluator, degradation_features)

__all__ = ["DEGRADATIONS", "EVALUATED_DEGRADATIONS", "SEVERITY_LEVELS",
           "DegradationClassifierV3", "SeverityEvaluator",
           "degradation_features"]
