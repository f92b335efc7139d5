"""Architecture + input-shape registry: the archs whose blocks the port
runs.  The reference's other archs raise in ``get_arch`` until the slice
that ports their blocks adds their config files."""
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek
from repro_torch.configs.demo_100m import CONFIG as _demo
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS: dict[str, ArchConfig] = {
    cfg.name: cfg
    for cfg in [_deepseek, _phi3, _gemma2, _danube, _zamba2, _mamba2, _llama4,
                _gemma3]}

# + auxiliary configs usable via --arch but outside the reference's
# assigned matrix
EXTRA_ARCHS: dict[str, ArchConfig] = {_demo.name: _demo}

NOT_PORTED = ("internvl2-2b", "whisper-large-v3")


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRA_ARCHS:
        return EXTRA_ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; available: "
                       f"{sorted(ARCHS) + sorted(EXTRA_ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; available: "
                   f"{sorted(ARCHS) + sorted(EXTRA_ARCHS)}")


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


__all__ = ["ARCHS", "EXTRA_ARCHS", "INPUT_SHAPES", "ArchConfig", "InputShape",
           "get_arch", "get_shape"]
