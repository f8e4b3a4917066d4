"""Imports every per-architecture config module (registration side
effects) and lists the assigned pool — the counterpart of
``repro.configs.archs``."""

from .whisper_large_v3 import *  # noqa: F401,F403
from .deepseek_v2_236b import *  # noqa: F401,F403
from .granite_moe_1b_a400m import *  # noqa: F401,F403
from .internvl2_76b import *  # noqa: F401,F403
from .minicpm3_4b import *  # noqa: F401,F403
from .llama3_2_1b import *  # noqa: F401,F403
from .qwen1_5_110b import *  # noqa: F401,F403
from .command_r_plus_104b import *  # noqa: F401,F403
from .mamba2_370m import *  # noqa: F401,F403
from .zamba2_7b import *  # noqa: F401,F403

ALL_ARCHS = [
    "whisper-large-v3",
    "deepseek-v2-236b",
    "granite-moe-1b-a400m",
    "internvl2-76b",
    "minicpm3-4b",
    "llama3.2-1b",
    "qwen1.5-110b",
    "command-r-plus-104b",
    "mamba2-370m",
    "zamba2-7b",
]
