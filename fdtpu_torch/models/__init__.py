from fdtpu_torch.models.score_models import (
    DiTScoreNetwork,
    LSTMScoreNetwork,
    MLPScoreNetwork,
    ScoreModel,
    ScoreModelConfig,
    ScoreNetwork,
    init_score_model,
    param_count,
    resolve_attention_impl,
    score_apply,
    score_apply_cached,
    score_apply_topk,
)
from fdtpu_torch.models.transformer import MODE_CACHED, MODE_FULL, MODE_MIXED

__all__ = [
    "MODE_CACHED",
    "MODE_FULL",
    "MODE_MIXED",
    "DiTScoreNetwork",
    "LSTMScoreNetwork",
    "MLPScoreNetwork",
    "ScoreModel",
    "ScoreModelConfig",
    "ScoreNetwork",
    "init_score_model",
    "param_count",
    "resolve_attention_impl",
    "score_apply",
    "score_apply_cached",
    "score_apply_topk",
]
