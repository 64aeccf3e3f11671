"""Core of the port: the PERKS loop combinators (``perks``), the cache
policy (``cache_policy``), the paper's performance model (``perf_model``)
and the card's constants (``hardware``)."""
from repro_torch.core.perks import Execution, PerksConfig, persistent
