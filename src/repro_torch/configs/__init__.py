"""Config registry of the port: only the architectures ported so far."""
from . import dit_audio, dit_t2i, dit_t2v, dit_video, dit_xl, zamba2_2p7b
from .base import ArchConfig

_MODULES = {"dit-xl": dit_xl, "dit-video": dit_video, "dit-audio": dit_audio,
            "dit-t2i": dit_t2i, "dit-t2v": dit_t2v,
            "zamba2-2.7b": zamba2_2p7b}
ALL_ARCH_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch '{arch_id}' is not ported to repro_torch yet "
                       f"(ported: {ALL_ARCH_IDS}); see ROADMAP.md §A")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


__all__ = ["ArchConfig", "ALL_ARCH_IDS", "get_config", "get_smoke_config"]
