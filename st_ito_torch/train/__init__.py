"""Training systems (``torch.optim``), the JAX package's ``st_ito_tpu/train``:
the pretext ParameterEstimator (``param``) and the learned-inference
StyleTransferSystem (``style``), on one card."""

from st_ito_torch.train.param import (
    ParamEstimatorConfig,
    ParamTrainState,
    init_param_estimator,
    make_param_train_block,
    make_param_train_step,
)

__all__ = [
    "ParamEstimatorConfig",
    "ParamTrainState",
    "init_param_estimator",
    "make_param_train_block",
    "make_param_train_step",
]
