from gpry_tpu_torch.acquisition.functions import (  # noqa: F401
    AcquisitionFunction,
    ConstantAcqFunc,
    ExpectedImprovement,
    LogExp,
    Mu,
    NonlinearLogExp,
    Std,
    builtin_names,
    is_acquisition_function,
)
from gpry_tpu_torch.acquisition.batch_optimizer import (  # noqa: F401
    BatchOptimizer,
)
from gpry_tpu_torch.acquisition.nora import NORA  # noqa: F401
from gpry_tpu_torch.acquisition.ranked_pool import RankedPool  # noqa: F401
