"""Architecture + input-shape registry: the archs whose blocks the port
runs.  The reference's other archs raise in ``get_arch`` until the slice
that ports their blocks adds their config files."""
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3

ARCHS: dict[str, ArchConfig] = {cfg.name: cfg for cfg in [_gemma3]}

NOT_PORTED = ("deepseek-v2-lite-16b", "demo-100m", "gemma2-27b",
              "h2o-danube-3-4b", "internvl2-2b", "llama4-scout-17b-a16e",
              "mamba2-780m", "phi3-medium-14b", "whisper-large-v3",
              "zamba2-7b")


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; available: "
                       f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


__all__ = ["ARCHS", "INPUT_SHAPES", "ArchConfig", "InputShape",
           "get_arch", "get_shape"]
