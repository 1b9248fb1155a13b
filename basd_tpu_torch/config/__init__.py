from basd_tpu_torch.config.core import (
    ConfigNode,
    compose,
    load_config,
    register_resolver,
    resolve,
    save_config,
)
from basd_tpu_torch.config.resolvers import register_resolvers

__all__ = [
    "ConfigNode",
    "compose",
    "load_config",
    "register_resolver",
    "register_resolvers",
    "resolve",
    "save_config",
]
