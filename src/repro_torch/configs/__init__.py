"""Config registry of the port: every architecture of the JAX package's
zoo (the DiTs, the dense LLMs, the moe LLMs arctic-480b and
deepseek-v2-236b, the hybrid zamba2, the Mamba1 falcon-mamba, the
encoder-decoder whisper and the vlm pixtral)."""
from . import (arctic_480b, deepseek_v2_236b, dit_audio, dit_t2i, dit_t2v,
               dit_video, dit_xl, falcon_mamba_7b, minitron_8b, pixtral_12b,
               qwen2_7b, qwen2p5_14b, tinyllama_1p1b, whisper_small,
               zamba2_2p7b)
from .base import INPUT_SHAPES, ArchConfig, InputShape

_MODULES = {"dit-xl": dit_xl, "dit-video": dit_video, "dit-audio": dit_audio,
            "dit-t2i": dit_t2i, "dit-t2v": dit_t2v,
            "tinyllama-1.1b": tinyllama_1p1b, "qwen2-7b": qwen2_7b,
            "qwen2.5-14b": qwen2p5_14b, "minitron-8b": minitron_8b,
            "zamba2-2.7b": zamba2_2p7b, "falcon-mamba-7b": falcon_mamba_7b,
            "whisper-small": whisper_small, "pixtral-12b": pixtral_12b,
            "arctic-480b": arctic_480b, "deepseek-v2-236b": deepseek_v2_236b}
ALL_ARCH_IDS = list(_MODULES)
#: the ten language architectures (JAX's ARCH_IDS), in its registry's order
ARCH_IDS = ["zamba2-2.7b", "qwen2-7b", "qwen2.5-14b", "arctic-480b",
            "minitron-8b", "pixtral-12b", "deepseek-v2-236b",
            "falcon-mamba-7b", "tinyllama-1.1b", "whisper-small"]


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}' (known: {ALL_ARCH_IDS})")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCH_IDS",
           "ALL_ARCH_IDS", "get_config", "get_smoke_config"]
