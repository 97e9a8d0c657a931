from gpry_tpu_torch.mc.nested import NSResult, run_nested_device  # noqa: F401
from gpry_tpu_torch.mc.samples import (  # noqa: F401
    mc_sample_from_gp,
    samples_dict_to_getdist,
)
