from .client import GangTokenClient, NativeTokenClient, TokenClient, connect_from_env
from .guard import ExecutionGuard, apply_hbm_cap, token_gated

__all__ = [
    "ExecutionGuard",
    "GangTokenClient",
    "NativeTokenClient",
    "TokenClient",
    "apply_hbm_cap",
    "connect_from_env",
    "token_gated",
]
