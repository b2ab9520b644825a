from repro_torch.nn.module import (
    Module,
    ParamDef,
    from_jax_params,
    init_params,
    materialize,
    normal_init,
    ones_init,
    param_defs,
    scaled_init,
    zeros_init,
)

__all__ = [
    "Module", "ParamDef", "from_jax_params", "init_params", "materialize",
    "normal_init", "ones_init", "param_defs", "scaled_init", "zeros_init",
]
