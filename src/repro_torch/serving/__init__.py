"""repro_torch.serving — serving engines of the port.

  engine    — ServingEngine: LLM prefill + rolling-KV continuous decode
  diffusion — DiffusionServingEngine: step-interleaved continuous batching
              of denoising trajectories (import `repro_torch.serving.diffusion`)
  common    — request-queue machinery shared by both engines
"""
from .common import RequestQueue
from .engine import GenerationResult, ServingEngine, greedy_generate

__all__ = ["RequestQueue", "ServingEngine", "GenerationResult",
           "greedy_generate"]
