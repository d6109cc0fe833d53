"""Minitron-8B — width-pruned Nemotron-4, 256k vocabulary [arXiv:2407.14679]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    source="arXiv:2407.14679",
)
SMOKE = CONFIG.reduced()
