from t2v_torch.core.config import (
    CLIPTextConfig,
    ModelScopeUNetConfig,
    T2VArgs,
    T2VOutputArgs,
    VAEConfig,
    VideoCrafterUNetConfig,
    sanity_check_args,
)
from t2v_torch.core.dtypes import Policy

__all__ = [
    "CLIPTextConfig", "ModelScopeUNetConfig", "Policy", "T2VArgs", "T2VOutputArgs",
    "VAEConfig", "VideoCrafterUNetConfig", "sanity_check_args",
]
