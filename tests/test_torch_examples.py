"""The port's examples run to their end on the CPU and print OK:
`examples/torch_quickstart.py` (exact vs TaylorSeer sampling),
`examples/torch_serve_diffusion.py` (the SLA autotuner, per-class serving
and the guided FasterCacheCFG pool) and
`examples/torch_mixed_modality_serving.py` (autotune per modality, the
mixed image + video + audio pool) and
`examples/torch_text_to_image_serving.py` (the prompted guided t2i queue
through the PromptCache and the per-slot text tables),
`examples/torch_online_control_plane.py` (SmoothCache, the OnlineTuner's
blue/green swaps, a gate learned from the serving traces) and
`examples/torch_observability.py` (the mixed pool's trace, cache-event
JSONL reconciled with telemetry, metrics and program profiles),
`examples/torch_cached_generation.py` (14 cache policies with CFG 1.5 on a
reduced DiT-XL, PSNR against exact), `examples/torch_diffusion_lm.py`
(mask-denoising generation on tinyllama SMOKE, exact, FORA, TaylorSeer and
TeaCache) and `examples/torch_serving_llm.py` (the ServingEngine over
tinyllama, deepseek-v2, falcon-mamba and zamba2 SMOKE), each at its JAX original's CPU size (a few seconds each here,
the policy zoo about 20 s)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_serve_diffusion.py",
                                    "torch_mixed_modality_serving.py",
                                    "torch_text_to_image_serving.py",
                                    "torch_online_control_plane.py",
                                    "torch_observability.py",
                                    "torch_cached_generation.py",
                                    "torch_diffusion_lm.py",
                                    "torch_serving_llm.py"])
def test_example_runs_on_the_cpu(script):
    # two intra-op threads, as the test processes use: beside the other
    # xdist workers an example on every core oversubscribes the CPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"
