"""Online linear learners — the Vowpal-Wabbit-equivalent engine on one
card.

The PyTorch port of the JAX package's ``models/online``: the learn loop
is minibatch AdaGrad-normalized steps over a blocked matrix on the
device, captured as CUDA graphs on the card (:mod:`.sgd`); the
featurizers, the VW text parser, ds-json ingestion and policy evaluation
run on the host.  VW's spanning-tree AllReduce is parameter averaging
over a ``ProcessMesh`` (``train_sgd(mesh=...)``, the estimators'
``mesh``).
"""

from .sgd import (SGDConfig, SGDState, predict_margin, state_from_jax,
                  state_to_numpy, train_sgd)
from .estimators import (OnlineSGDClassifier, OnlineSGDClassificationModel,
                         OnlineSGDRegressor, OnlineSGDRegressionModel)
from .dsjson import DSJsonTransformer
from .featurizer import (FeatureInteractions, HashingFeaturizer,
                         VectorZipper)
from .bandit import (ContextualBandit, ContextualBanditModel)
from .generic import (OnlineGeneric, OnlineGenericModel,
                      OnlineGenericProgressive, parse_vw_line,
                      vectorize_vw_lines)
from .policyeval import (CressieReadInterval, PolicyEvalTransformer,
                         bernstein_bound, cressie_read, ips, snips)

__all__ = [
    "SGDConfig", "SGDState", "train_sgd", "predict_margin",
    "state_from_jax", "state_to_numpy",
    "OnlineSGDClassifier", "OnlineSGDClassificationModel",
    "OnlineSGDRegressor", "OnlineSGDRegressionModel",
    "DSJsonTransformer", "HashingFeaturizer", "FeatureInteractions",
    "VectorZipper",
    "ContextualBandit", "ContextualBanditModel",
    "OnlineGeneric", "OnlineGenericModel", "OnlineGenericProgressive",
    "parse_vw_line", "vectorize_vw_lines",
    "PolicyEvalTransformer", "CressieReadInterval",
    "ips", "snips", "cressie_read", "bernstein_bound",
]
