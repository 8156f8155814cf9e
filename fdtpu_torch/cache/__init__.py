from fdtpu_torch.cache.e2crf import (
    CacheState,
    E2CRFConfig,
    PolicyParams,
    cache_stats,
    effective_tau,
    guard_relative_error,
    init_cache_state,
    record_guard_measurement,
    score_skip_decision,
)

__all__ = [
    "CacheState",
    "E2CRFConfig",
    "PolicyParams",
    "cache_stats",
    "effective_tau",
    "guard_relative_error",
    "init_cache_state",
    "record_guard_measurement",
    "score_skip_decision",
]
