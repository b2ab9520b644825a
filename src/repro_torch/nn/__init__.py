from repro_torch.nn.module import (
    Module,
    ParamDef,
    count_params,
    from_jax_params,
    init_module,
    init_params,
    layer_views,
    materialize,
    normal_init,
    ones_init,
    param_defs,
    scaled_init,
    specs_of,
    stack_params,
    trainable,
    zeros_init,
)

__all__ = [
    "Module", "ParamDef", "count_params", "from_jax_params", "init_module", "init_params",
    "layer_views", "materialize", "normal_init", "ones_init", "param_defs", "scaled_init",
    "specs_of", "stack_params", "trainable", "zeros_init",
]
