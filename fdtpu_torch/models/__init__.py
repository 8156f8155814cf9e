from fdtpu_torch.models.score_models import (
    ScoreModel,
    ScoreModelConfig,
    ScoreNetwork,
    init_score_model,
    param_count,
    resolve_attention_impl,
    score_apply,
)

__all__ = [
    "ScoreModel",
    "ScoreModelConfig",
    "ScoreNetwork",
    "init_score_model",
    "param_count",
    "resolve_attention_impl",
    "score_apply",
]
