"""String-valued enums mirroring the reference's option vocabulary.

A copy of `laplace_jax/enums.py` (the port imports nothing of the JAX
package): the same member values, so user-facing strings ("all", "kron",
"probit", ...) mean the same in both packages.
"""

from __future__ import annotations

from enum import Enum


class SubsetOfWeights(str, Enum):
    """Valid options for `subset_of_weights`."""

    ALL = "all"
    LAST_LAYER = "last_layer"
    SUBNETWORK = "subnetwork"


class HessianStructure(str, Enum):
    """Valid options for `hessian_structure`."""

    FULL = "full"
    KRON = "kron"
    DIAG = "diag"
    LOWRANK = "lowrank"
    GP = "gp"


class Likelihood(str, Enum):
    """Valid options for `likelihood`."""

    REGRESSION = "regression"
    CLASSIFICATION = "classification"
    REWARD_MODELING = "reward_modeling"


class PredType(str, Enum):
    """Valid options for `pred_type`."""

    GLM = "glm"
    NN = "nn"
    GP = "gp"


class LinkApprox(str, Enum):
    """Valid options for `link_approx` (classification only)."""

    MC = "mc"
    PROBIT = "probit"
    BRIDGE = "bridge"
    BRIDGE_NORM = "bridge_norm"


class TuningMethod(str, Enum):
    """Valid options for `method` in `optimize_prior_precision`."""

    MARGLIK = "marglik"
    GRIDSEARCH = "gridsearch"


class PriorStructure(str, Enum):
    """Valid options for `prior_structure` in `optimize_prior_precision`."""

    SCALAR = "scalar"
    DIAG = "diag"
    LAYERWISE = "layerwise"


class FeatureReduction(str, Enum):
    """How to reduce >2-dim penultimate features to (batch, dim).

    Parity: `laplace/utils/feature_extractor.py:13-18`.
    """

    PICK_FIRST = "pick_first"
    PICK_LAST = "pick_last"
    AVERAGE = "average"
