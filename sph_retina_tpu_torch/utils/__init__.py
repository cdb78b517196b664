"""Host-side helpers: configs, published weights, the device, the
environment log, the CPU fingerprint and the device-OOM ladder."""

from .env import collect_env, env_string
from .hostfp import cpu_feature_fingerprint
from .memory import AvoidOOM, is_oom_error

__all__ = [
    "AvoidOOM",
    "collect_env",
    "cpu_feature_fingerprint",
    "env_string",
    "is_oom_error",
]
