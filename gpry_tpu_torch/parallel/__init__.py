from gpry_tpu_torch.parallel.executor import TruthExecutor  # noqa: F401
from gpry_tpu_torch.parallel.rng import get_random_generator  # noqa: F401
